"""Command-line entry points: ``python -m repro_torch.launch.serve``.

Counterpart of ``repro.launch`` (serving only; training, the dry run and
the mesh launcher belong to later slices).
"""
