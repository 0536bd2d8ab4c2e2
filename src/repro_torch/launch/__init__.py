"""Command-line entry points: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``, the meshes they run on
(:mod:`.mesh`) and the step functions (:mod:`.steps`).

Counterpart of ``repro.launch`` (the dry run is not ported yet: ROADMAP.md
queue 1 item 27).
"""
