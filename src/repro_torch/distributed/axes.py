"""Mesh records, the shard policy and the collectives of the model code.

Counterpart of ``repro.distributed.axes``.  A mesh here is either a
``torch.distributed.device_mesh.DeviceMesh`` named ``("data", "model")``
(what :mod:`repro_torch.launch.mesh` builds over the initialised default
group) or an :class:`AbstractMesh`, a plain record of axis sizes and names:
the sharding rules need shapes only, never 256 ranks.

The serving engine and the trainer install a :class:`ShardPolicy` around
each of their steps (:func:`policy`), and the model reads it.  Serving: the
row-parallel products (``wo``, ``w_down``), the vocab-sharded embedding and
logits and the MoE's gated sum add their ranks' shares with :func:`psum`,
one ``all_reduce`` in place, over the ranks the product's inner dim is
split among (:func:`split_place`): the model axis where a rank holds 1/M of
it, every rank of a ``D x M`` mesh where it holds 1/(D*M) -- the JAX serve
mode's weights, resident and split over all axes, model-major (rank ``(d,
m)`` holds block ``m*D + d``).  Such a column-parallel attention product is
gathered over the data axis into the rank's model slice of heads
(:func:`data_gather`), where its pools lie, and the row-parallel ``wo``
multiplies the rank's data part of the attention output
(:func:`data_part`).  The rare leaf the serve layout stores in no layout
the model computes on is gathered before a step reads it
(:func:`resident`).  Training (a policy made by :func:`make_train_policy`)
runs the same sites through autograd functions in the Megatron pattern:

* :func:`psum` -- the row-parallel sum: ``all_reduce`` forward, identity
  backward;
* :func:`enter` -- the entry of a column-parallel region: identity forward,
  ``all_reduce`` of the gradient over the model axis backward (a no-op in
  serving);
* :func:`gather_slices` -- an all-gather whose backward keeps the rank's
  slice of the gradient;
* :func:`data_sum` -- a sum over the data axis, forward and backward (each
  data rank's loss is its share of the global loss);
* :func:`materialize` -- ZeRO's gather before use: a leaf stored as the
  rank's slice over ``data`` (and, where the model runs it whole, over
  ``model``) is gathered into what the model reads; its backward sums the
  gradient over ``data`` and keeps the rank's slice.

Every collective is an ``all_reduce`` (an all-gather is a sum of
zero-padded slices, exact), the one operation gloo offers on CUDA tensors
besides ``broadcast``, so one mechanism runs on the CPU and on the card.
Outside a policy (single device, tests) every one of them is a no-op, and
where the model finds a leaf cut over the model axis with no policy
installed, :func:`model_coord` and :func:`check_split` raise.

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
class LeafUse:
    """How the model reads one stored leaf: the dim split over the data
    axis that ZeRO gathers first (None: not split there), then the dim
    split over the model axis that the model runs whole (None: it runs the
    rank's slice, or the leaf is not split there), then, in serving, the
    dim whose model slice the rank cuts from the whole (None: none)."""

    data_dim: Optional[int] = None
    model_dim: Optional[int] = None
    cut_dim: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ShardPolicy:
    """What a rank's model code needs of the mesh: the model axis's process
    group, this rank's coordinate on it and its size; the data axis's
    group, coordinate and size; in serving the group of every rank
    (``world``); in training whether the batch rows split over the data
    axis (``rows_split``); and ``plan``: in training a :class:`LeafUse`
    tree per top-level parameter key (per layer for a stacked key), in
    serving one per key whose stored leaves the model cannot read as they
    are (whole stacks; :func:`resident`)."""

    group: object = dataclasses.field(compare=False)
    tp_rank: int
    tp_size: int
    dp_group: object = dataclasses.field(default=None, compare=False)
    dp_rank: int = 0
    dp_size: int = 1
    rows_split: bool = False
    train: bool = False
    plan: object = dataclasses.field(default=None, compare=False)
    world: object = dataclasses.field(default=None, compare=False)


def make_policy(mesh, plan=None, groups=None) -> ShardPolicy:
    """The serving policy of a ``D x M`` ``DeviceMesh``: both axes' groups
    (:func:`axis_groups`, or ``groups`` made by it), the default group as
    ``world``, this rank's coordinates, and ``plan`` (the serve layout's
    gathers, :meth:`repro_torch.distributed.sharding.ServeLayout.plan`)."""
    groups = axis_groups(mesh) if groups is None else groups
    shape, coords = mesh_shape(mesh), mesh_coords(mesh)
    return ShardPolicy(group=groups["model"], tp_rank=coords["model"], tp_size=shape["model"],
                       dp_group=groups["data"], dp_rank=coords["data"], dp_size=shape["data"],
                       plan=plan, world=dist.group.WORLD)


def _default_timeout():
    """The default group's timeout (the caller's ``init_process_group``
    timeout), for the subgroups made here; None where this version of
    ``torch.distributed`` does not show it (the library's default)."""
    try:
        return dist.group.WORLD._get_backend(torch.device("cpu")).options._timeout
    except (AttributeError, RuntimeError):
        return None


_GROUPS: Dict[int, Tuple[object, Dict[str, object]]] = {}


def axis_groups(mesh) -> Dict[str, object]:
    """This rank's process group on each axis of a ``D x M`` ``DeviceMesh``:
    the default group where the axis spans every rank, else a group made
    here with the default group's timeout (every rank calls this, in the
    same order: ``new_group`` is collective), once per mesh.  A group's
    ranks are sorted, so a rank's place in it is its coordinate on the
    axis."""
    if isinstance(mesh, AbstractMesh):
        raise TypeError("an abstract mesh has no ranks: build the mesh with "
                        "repro_torch.launch.mesh over a process group")
    if id(mesh) in _GROUPS:  # the mesh is held there, so its id is not reused
        return _GROUPS[id(mesh)][1]
    ids = mesh.mesh  # (D, M) global ranks
    coords = mesh_coords(mesh)
    world = dist.get_world_size()
    timeout = _default_timeout()
    out = {}
    for axis, lines in (("data", ids.T), ("model", ids)):
        if lines.shape[1] == 1:  # an axis of one rank reduces nothing
            out[axis] = None
            continue
        if lines.shape[1] == world:
            out[axis] = dist.group.WORLD
            continue
        mine = lines[coords["model" if axis == "data" else "data"]].tolist()
        for line in lines.tolist():  # every rank makes every group
            g = dist.new_group(line, timeout=timeout)
            if line == mine:
                out[axis] = g
    _GROUPS[id(mesh)] = (mesh, out)
    return out


def make_train_policy(mesh, plan, *, rows_split: bool, groups=None) -> ShardPolicy:
    """The training policy of a ``D x M`` ``DeviceMesh``: both axes' groups
    (:func:`axis_groups`, or ``groups`` made once by it), this rank's
    coordinates, and ``plan`` (:class:`LeafUse` trees by parameter key)."""
    groups = axis_groups(mesh) if groups is None else groups
    shape, coords = mesh_shape(mesh), mesh_coords(mesh)
    return ShardPolicy(group=groups["model"], tp_rank=coords["model"], tp_size=shape["model"],
                       dp_group=groups["data"], dp_rank=coords["data"],
                       dp_size=shape["data"], rows_split=rows_split, train=True, plan=plan)


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
    holds ``local`` of ``full`` (a rank's heads, experts or widths) and no
    installed policy splits it so (:func:`split_place`)."""
    if local != full:
        split_place(local, full, what)


class _SumForward(torch.autograd.Function):
    """``all_reduce`` forward, identity backward: the row-parallel sum
    (each rank's loss is the whole loss, so each keeps its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Identity forward, ``all_reduce`` of the gradient backward: the entry
    of a column-parallel region (a replicated activation whose gradient
    each rank holds a share of)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumBoth(torch.autograd.Function):
    """``all_reduce`` forward and backward: a sum over ranks whose losses
    are shares of one loss, each reading the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """The whole of a tensor split evenly along ``dim`` over ``group``, from
    this rank's slice: zeros with the slice written at the rank's place,
    summed by one ``all_reduce`` (exact).  Backward: the rank's slice of the
    gradient, summed over the group first where ``reduce`` (the ranks'
    gradients are shares) and taken as it is where not (every rank holds
    the same gradient)."""

    @staticmethod
    def forward(ctx, local, dim, rank, size, group, reduce):
        ctx.dim, ctx.rank, ctx.n, ctx.group, ctx.reduce = dim, rank, local.shape[dim], group, reduce
        shape = list(local.shape)
        shape[dim] = local.shape[dim] * size
        out = local.new_zeros(shape)
        out.narrow(dim, rank * ctx.n, ctx.n).copy_(local)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None, None, None


def _training(pol: Optional[ShardPolicy]) -> bool:
    return pol is not None and pol.train


def split_place(local: int, full: int, what: str = "a split dim") -> Tuple[int, int, object]:
    """(this rank's place, the number of places, their group) of a dim the
    model reads ``local`` of ``full`` entries of: ``(0, 1, None)`` where it
    holds all of them; the model axis where it holds 1/M; in serving on a
    ``D x M`` mesh, every rank, model-major (place ``m*D + d``), where it
    holds 1/(D*M).  Raises, as :func:`model_coord` does, where no installed
    policy splits the dim so."""
    if local == full:
        return 0, 1, None
    pol = _CURRENT
    if pol is not None and pol.tp_size > 1 and full == local * pol.tp_size:
        return pol.tp_rank, pol.tp_size, pol.group
    if pol is not None and not pol.train and pol.dp_size > 1 and \
            full == local * pol.dp_size * pol.tp_size:
        return pol.tp_rank * pol.dp_size + pol.dp_rank, pol.dp_size * pol.tp_size, pol.world
    model_coord(f"{what} ({local} of {full})")
    raise RuntimeError(f"{what} holds {local} of {full}: no split of this mesh's axes")


def psum(x: torch.Tensor, local: int, full: int, what: str = "a split product") -> torch.Tensor:
    """Sum ``x``, a product over an inner dim of ``full`` entries of which
    the rank holds ``local``, over the ranks that share that dim
    (:func:`split_place`): one ``all_reduce`` (every rank gets the same
    bits), in place in serving, through :class:`_SumForward` in training.
    A no-op outside a policy of several ranks, or where the rank holds the
    whole dim (its leaves whole on each rank, so each rank holds the whole
    sum)."""
    pol = _CURRENT
    if pol is None or pol.tp_size * pol.dp_size == 1:
        return x
    _, n, group = split_place(local, full, what)
    if n == 1:
        return x
    if group is None:
        raise RuntimeError("the shard policy of an abstract mesh has no process group")
    if _CURRENT.train:
        return _SumForward.apply(x, group)
    dist.all_reduce(x, group=group)
    return x


def enter(x: torch.Tensor, split: bool = True) -> torch.Tensor:
    """The entry of a column-parallel region: ``x`` as it is, and in
    training its gradient summed over the model axis (the rank's heads or
    widths give a share of it).  A no-op outside training, on a model axis
    of one rank, or where the product is not ``split``."""
    pol = _CURRENT
    if not _training(pol) or pol.tp_size == 1 or not split:
        return x
    return _SumBackward.apply(x, pol.group)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the data axis, forward and backward (each data rank's
    loss is a share of the global loss and reads the sum): the global
    token counts and means of the loss.  A no-op outside training or on a
    data axis of one rank."""
    pol = _CURRENT
    if not _training(pol) or pol.dp_size == 1:
        return x
    return _SumBoth.apply(x, pol.dp_group)


def row_split() -> Tuple[int, int]:
    """(this rank's place, the number of places) of its batch rows in the
    global batch: the data axis where the rows split over it, else (0, 1)."""
    pol = _CURRENT
    if not _training(pol) or not pol.rows_split:
        return 0, 1
    return pol.dp_rank, pol.dp_size


def data_size() -> int:
    """The data axis's size under a training policy, else 1."""
    pol = _CURRENT
    return pol.dp_size if _training(pol) else 1


def _use(x: torch.Tensor, use: Optional[LeafUse], pol: ShardPolicy) -> torch.Tensor:
    if use is None:
        return x
    if not pol.train:  # serving: plain collectives, then the model slice
        if use.data_dim is not None:
            x = _gather(x, use.data_dim, pol.dp_rank, pol.dp_size, pol.dp_group)
        if use.model_dim is not None:
            x = _gather(x, use.model_dim, pol.tp_rank, pol.tp_size, pol.group)
        if use.cut_dim is not None:
            n = x.shape[use.cut_dim] // pol.tp_size
            x = x.narrow(use.cut_dim, pol.tp_rank * n, n).contiguous()
        return x
    if use.data_dim is not None:
        x = _Gather.apply(x, use.data_dim, pol.dp_rank, pol.dp_size, pol.dp_group, True)
    if use.model_dim is not None:
        x = _Gather.apply(x, use.model_dim, pol.tp_rank, pol.tp_size, pol.group, False)
    return x


def _map_uses(tree, uses, pol):
    if isinstance(tree, dict):
        return {k: _map_uses(v, uses.get(k), pol) if uses else v for k, v in tree.items()}
    return _use(tree, uses, pol)


def materialize(tree, key: str):
    """What the model reads of ``tree``, the stored leaves of parameter
    ``key`` (one layer's, for a stacked key): each gathered over the data
    axis and, where the model runs it whole, the model axis, as the
    training policy's plan says.  Inside a layer recomputed by ``remat``
    the gathered leaves live only while the layer runs.  The tree as it is
    outside a training policy."""
    pol = _CURRENT
    if not _training(pol) or pol.plan is None:
        return tree
    return _map_uses(tree, pol.plan[key], pol)


def gather_stack(key_path: Tuple[str, ...], stack: torch.Tensor) -> torch.Tensor:
    """A stacked leaf whose layer axis is split over the data axis, gathered
    whole before it is cut into layers (the per-layer gather of
    :func:`materialize` cannot reach another rank's layer); any other leaf
    as it is."""
    pol = _CURRENT
    if not _training(pol) or pol.plan is None:
        return stack
    uses = pol.plan.get(("stack",) + tuple(key_path))
    if uses is None:
        return stack
    return _use(stack, uses, pol)


def _gather(local: torch.Tensor, dim: int, rank: int, size: int, group) -> torch.Tensor:
    """Serving's all-gather: zeros with ``local`` at the rank's place, one
    ``all_reduce`` (exact: every element is one rank's value plus zeros)."""
    n = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * size
    out = local.new_zeros(shape)
    out.narrow(dim, rank * n, n).copy_(local)
    dist.all_reduce(out, group=group)
    return out


def gather_slices(local: torch.Tensor, full: int, dim: int = -1,
                  what: str = "a slice") -> torch.Tensor:
    """The whole of a tensor whose ``dim`` is split evenly over the ranks
    of :func:`split_place`, from this rank's slice: each rank writes its
    slice into zeros and one ``all_reduce`` adds them (an all-gather from
    ``all_reduce`` alone, which every backend offers for CUDA tensors).
    Exact: every element is one rank's value plus zeros.  In training the
    backward keeps the rank's slice of the gradient (every rank's loss is
    the whole loss)."""
    if local.shape[dim] == full:
        return local
    rank, size, group = split_place(local.shape[dim], full, what)
    dim = dim % local.dim()
    if _CURRENT.train:
        return _Gather.apply(local, dim, rank, size, group, False)
    return _gather(local, dim, rank, size, group)


def _serving_data(pol: Optional[ShardPolicy]) -> bool:
    return pol is not None and not pol.train and pol.dp_size > 1


def data_gather(local: torch.Tensor, full: int, dim: int = -1) -> torch.Tensor:
    """A column-parallel product of ``full`` columns that the rank holds
    1/(D*M) of (the serve layout's model-major block ``m*D + d``), gathered
    over the data axis into the rank's model slice (1/M of ``full``: the
    heads its pools hold); anything else as it is."""
    pol = _CURRENT
    if not _serving_data(pol) or local.shape[dim] * pol.dp_size * pol.tp_size != full:
        return local
    return _gather(local, dim % local.dim(), pol.dp_rank, pol.dp_size, pol.dp_group)


def data_part(x: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """The part of ``x`` (a model slice) that a row block of ``n`` entries
    multiplies: ``x`` where the block is all of it; in serving on a data
    axis, the rank's ``d``-th of ``D`` parts, where the block is the serve
    layout's 1/(D*M) of the rows."""
    if x.shape[dim] == n:
        return x
    pol = _CURRENT
    if _serving_data(pol) and x.shape[dim] == n * pol.dp_size:
        return x.narrow(dim, pol.dp_rank * n, n)
    raise RuntimeError(f"a row block of {n} does not multiply {x.shape[dim]} entries "
                       "on this mesh")


def resident(tree, key: str):
    """Serving: the stored leaves of parameter ``key`` (whole stacks) as
    the model reads them -- the leaves of the serve policy's plan gathered
    (:class:`LeafUse`: over ``data``, over ``model``, then the rank's model
    slice cut), the rest as they are.  The tree as it is outside a serving
    policy with a plan, or for a key the plan does not name."""
    pol = _CURRENT
    if pol is None or pol.train or not pol.plan or key not in pol.plan:
        return tree
    return _map_uses(tree, pol.plan[key], pol)
