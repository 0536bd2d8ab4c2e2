"""Mesh construction over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  A function, not a module-level
constant, so importing this module never touches the process group.  The
meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects named
``("data", "model")`` over the default process group, which the caller
initialises (``torch.distributed.init_process_group`` with its backend,
rank, world size and a ``timeout``; ``torchrun``,
``python -m repro_torch.launch.serve --mesh DxM`` or
``python -m repro_torch.launch.train --mesh local`` starts the ranks).
The trainer (:func:`make_mesh`) and serving (:func:`make_serve_mesh`) take
any ``D x M`` mesh.
"""
from __future__ import annotations

import torch


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's 256- and 512-chip production meshes exist for the
    dry run, which is not ported yet (ROADMAP.md queue 1 item 27).  The
    sharding rules take :func:`repro_torch.distributed.axes.abstract_mesh`
    records of those shapes."""
    raise NotImplementedError(
        "make_production_mesh belongs to the dry run, not ported yet (ROADMAP.md "
        "queue 1 item 27); validate rules on abstract_mesh((16, 16), "
        "('data', 'model')) instead")


def _require_group():
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: start the ranks under torchrun (or let "
            "`python -m repro_torch.launch.serve --mesh DxM` spawn them) and call "
            "torch.distributed.init_process_group(backend, rank=, world_size=, "
            "timeout=) before building a mesh")
    return dist


def _mesh(d: int, m: int):
    from torch.distributed.device_mesh import DeviceMesh

    dist = _require_group()
    # gloo (the CPU, or ranks sharing one card) keeps its groups on the CPU
    # side; NCCL's are the card's
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(d * m).reshape(d, m),
                      mesh_dim_names=("data", "model"))


def make_local_mesh():
    """Every rank of the default group on the model axis: ``(1, world)``."""
    dist = _require_group()
    return _mesh(1, dist.get_world_size())


def parse_mesh(spec: str):
    """``"DxM"`` -> ``(D, M)``, with the JAX CLI's messages."""
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        raise ValueError(f"--mesh expects DxM (e.g. 1x4), got {spec!r}")
    d, m = int(parts[0]), int(parts[1])
    if d < 1 or m < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {spec!r}")
    return d, m


def make_serve_mesh(spec: str):
    """Parse a ``--mesh DxM`` spec (e.g. ``2x2``) into a ``(D, M)`` mesh
    named ``("data", "model")``: the weights shard over both axes, the KV
    pools over ``M``, the model (tensor-parallel) axis, and replicate over
    ``D``.  Needs a default group of exactly ``D*M`` ranks."""
    return make_mesh(spec)


def make_mesh(spec: str):
    """A ``"DxM"`` spec as a ``(D, M)`` mesh named ``("data", "model")``
    over a default group of exactly ``D*M`` ranks, rank ``d*M + m`` at
    ``(d, m)``: for training, ``D`` the data axis (batch rows, ZeRO
    storage) and ``M`` the model axis (tensor parallelism)."""
    d, m = parse_mesh(spec)
    dist = _require_group()
    n = dist.get_world_size()
    if d * m != n:
        raise ValueError(
            f"--mesh {spec} needs {d * m} ranks but the process group has {n}; "
            f"start {d * m} (torchrun --nproc-per-node {d * m} ..., or "
            f"`python -m repro_torch.launch.serve --mesh {spec}`, which spawns them)")
    return _mesh(d, m)
