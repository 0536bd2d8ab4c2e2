"""Mesh records, the shard policy and the model-axis reduction.

Counterpart of ``repro.distributed.axes``.  A mesh here is either a
``torch.distributed.device_mesh.DeviceMesh`` named ``("data", "model")``
(what :func:`repro_torch.launch.mesh.make_serve_mesh` builds over the
initialised default group) or an :class:`AbstractMesh`, a plain record of
axis sizes and names: the sharding rules need shapes only, never 256 ranks.

The serving engine installs a :class:`ShardPolicy` around each of its steps
(:func:`policy`), and the model reads it: the row-parallel products (``wo``,
``w_down``), the vocab-sharded embedding and logits and the MoE's gated sum
add their ranks' shares with :func:`psum`, one ``all_reduce`` over the
model axis.  Outside a policy (single device, training, tests) :func:`psum`
is a no-op, and where the model finds a leaf cut over the model axis with
no policy installed, :func:`model_coord` and :func:`check_split` raise.

The JAX package's ``traced_under`` and ``constrain`` exist for ``jit`` and
GSPMD, its automatic partitioner: they carry the policy to trace time and
pin activation layouts for the partitioner.  Eager code has neither a trace
time nor a partitioner -- each rank holds its shards and runs its local
heads and widths -- so they have no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names without ranks (rule validation, tests)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    """The counterpart of the JAX package's ``abstract_mesh``: a record of
    ``axis_sizes`` and ``axis_names``."""
    sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} axis sizes for {len(names)} names")
    return AbstractMesh(sizes, names)


def is_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, (AbstractMesh, DeviceMesh))


def mesh_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of either kind of mesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh_names(mesh), mesh.shape))


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on every axis (all 0 on an abstract mesh)."""
    if isinstance(mesh, AbstractMesh):
        return {n: 0 for n in mesh.axis_names}
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh_names(mesh), coord))


@dataclasses.dataclass(frozen=True)
class ShardPolicy:
    """What a rank's model code needs of the mesh: the model axis's process
    group, this rank's coordinate on it and its size."""

    group: object = dataclasses.field(compare=False)
    tp_rank: int
    tp_size: int


def make_policy(mesh) -> ShardPolicy:
    """The shard policy of a ``DeviceMesh`` with a ``"model"`` axis.  Where
    the model axis spans every rank (the ``1 x M`` meshes that serving
    takes) its group is the default group, which carries the caller's
    timeout; a model axis of part of the world uses the mesh's own group."""
    if isinstance(mesh, AbstractMesh):
        raise TypeError("an abstract mesh has no ranks: build the mesh with "
                        "repro_torch.launch.mesh.make_serve_mesh over a process group")
    size = mesh_shape(mesh)["model"]
    group = dist.group.WORLD if size == dist.get_world_size() else mesh.get_group("model")
    return ShardPolicy(group=group, tp_rank=mesh_coords(mesh)["model"], tp_size=size)


_CURRENT: Optional[ShardPolicy] = None


def current() -> Optional[ShardPolicy]:
    return _CURRENT


@contextlib.contextmanager
def policy(mesh):
    """Install the shard policy of ``mesh`` (a mesh, a :class:`ShardPolicy`
    made once by :func:`make_policy`, or None for none) for the scope."""
    global _CURRENT
    prev = _CURRENT
    if mesh is None or isinstance(mesh, ShardPolicy):
        _CURRENT = mesh
    else:
        _CURRENT = make_policy(mesh)
    try:
        yield _CURRENT
    finally:
        _CURRENT = prev


def model_coord(what: str = "a sharded parameter") -> Tuple[int, int]:
    """(this rank's coordinate on the model axis, the axis size).  The model
    asks only where it holds a leaf cut over the model axis, so it raises
    outside a policy of more than one rank: a rank's shards run without
    their peers would give wrong numbers and no error (every :func:`psum` a
    no-op, every slice read as rank 0's)."""
    pol = _CURRENT
    if pol is None or pol.tp_size == 1:
        raise RuntimeError(
            f"{what} holds one rank's shard, but no shard policy of a model axis of "
            f"several ranks is installed; run a rank's shards through Engine or Server "
            f"(mesh=), or under repro_torch.distributed.axes.policy(mesh)")
    return pol.tp_rank, pol.tp_size


def check_split(local: int, full: int, what: str) -> None:
    """Raise, as :func:`model_coord` does, where a dimension the model reads
    holds ``local`` of ``full`` (a rank's heads, experts or widths) with no
    policy installed."""
    if local != full:
        model_coord(f"{what} ({local} of {full})")


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the model axis, in place, and return it: one
    ``all_reduce`` (every rank gets the same bits).  A no-op outside a
    policy or on a model axis of one rank."""
    pol = _CURRENT
    if pol is None or pol.tp_size == 1:
        return x
    if pol.group is None:
        raise RuntimeError("the shard policy of an abstract mesh has no process group")
    dist.all_reduce(x, group=pol.group)
    return x


def gather_slices(local: torch.Tensor, full: int, dim: int = -1) -> torch.Tensor:
    """The whole of a tensor whose ``dim`` is split evenly over the model
    axis, from this rank's slice: each rank writes its slice into zeros and
    one :func:`psum` adds them (an all-gather from ``all_reduce`` alone,
    which every backend offers for CUDA tensors).  Exact: every element is
    one rank's value plus zeros."""
    if local.shape[dim] == full:
        return local
    rank, _ = model_coord("a slice of the model axis")
    dim = dim % local.dim()
    n = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = full
    out = local.new_zeros(shape)
    out.narrow(dim, rank * n, n).copy_(local)
    return psum(out)
