"""Sharding rules: parameter / optimizer / batch / cache partition specs.

Counterpart of ``repro.distributed.sharding``, as metadata.  A spec is a
tuple with one entry per dimension, each an axis name, a tuple of axis
names or None -- the entries of the JAX package's ``PartitionSpec``, so a
test can hold the two entry for entry.  A spec tree mirrors its shape tree
(nested dicts whose leaves are tensors or shapes).

The production mesh is ``(pod, data, model)`` (multi-pod) or ``(data,
model)`` (single pod).  Axis roles:

* DP/FSDP -- batch and ZeRO-sharded parameter/optimizer storage over
  ``("pod", "data")``;
* TP -- attention-head / FFN-hidden / expert / vocab dims over ``"model"``
  (Megatron column/row pattern);
* EP -- MoE expert dim over ``"model"`` when E divides; otherwise the
  per-expert hidden is TP-sharded instead (granite's 40 experts vs a
  16-way axis);
* SP -- decode caches shard the *sequence* dim so 32k/500k contexts fit.

Rules are name/shape driven: each parameter leaf's path decides its base TP
spec, then the ZeRO extension shards the largest remaining dim over the data
axes when divisible.  Anything non-divisible falls back: the rules produce
valid specs for every architecture in the pool.

Where the JAX package hands the specs to ``device_put`` and GSPMD, this port
places tensors itself.  :func:`local_shard` cuts one rank's slice of a full
tensor by a spec.  The serving engine keeps, on each rank of a ``D x M``
mesh, exactly its share of the JAX serve spec (:class:`ServeLayout`,
:func:`serve_placement`): weights resident and split over all axes, 1-D
over ``("data", "model")`` wherever the base rules divide ``D*M``, else 2-D
or TP plus ZeRO storage.  A dim split over both axes is stored
**model-major** (rank ``(d, m)`` holds block ``m*D + d``, where a
``NamedSharding`` holds ``d*M + m``): each rank stores as many bytes, and a
gather over ``data`` yields the contiguous model slice that the pools, over
``model`` only, and the ``1 x M`` path use.  Leaves the ``1 x M`` rules
replicate -- norms, routers, SSM weights, ``wkv_a`` and position tables,
which the serve mode shards only by its 2-D fallback -- ``wq_a``, whose
output the q RMSNorm needs whole (GSPMD gathers it there), and an attention
whose heads the model axis does not split whole (GSPMD shards its columns)
the port keeps whole on every rank (:func:`whole_leaves`).

The trainer stores, on each rank, its slice of every leaf and of both its
moments under :func:`train_placement` -- exactly the train-mode specs:
Megatron TP over ``model``, ZeRO storage over ``data``, every leaf
replicated below :data:`REPLICATE_BELOW` (pure DP).  :class:`TrainLayout`
draws and cuts those slices, and tells the model (through the training
policy's plan, :func:`repro_torch.distributed.axes.materialize`) how to
gather each leaf into what it reads: over ``data`` always, over ``model``
where the model runs it whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import axes as AX
from repro_torch.distributed.axes import AbstractMesh, mesh_coords, mesh_names, mesh_shape

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...]  # data-parallel axes (("pod","data") or ("data",))
    tp: str = "model"

    @staticmethod
    def from_mesh(mesh) -> "MeshAxes":
        return MeshAxes(dp=tuple(n for n in mesh_names(mesh) if n != "model"), tp="model")


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh)[name]


def _dp_size(mesh, ax: MeshAxes) -> int:
    return math.prod(_axis_size(mesh, a) for a in ax.dp)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def flat_items(tree, path: Tuple[str, ...] = ()):
    """(path, leaf) over a nested-dict tree, in its key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_items(v, path + (str(k),))
    else:
        yield path, tree


def _map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a nested-dict tree (any non-dict is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


# --------------------------------------------------------------------------
# Base TP rules
# --------------------------------------------------------------------------

_COL_PARALLEL = (  # shard output (last) dim over tp
    "wq", "wk", "wv", "w_gate", "w_up", "wq_b", "wkv_b", "wq_a", "lm_head",
    "bq", "bk", "bv", "b_up",
)
_ROW_PARALLEL = ("wo", "w_down")  # shard input (second-to-last) dim over tp


def _base_tp_spec(name: str, shape: Tuple[int, ...], tp, tp_size: int,
                  stacked: bool, cfg: ModelConfig) -> Spec:
    """TP placement by parameter name.  ``stacked`` = leading L axis."""
    off = 1 if stacked else 0
    none = [None] * len(shape)

    def spec(idx, axis):
        s = list(none)
        s[idx] = axis
        return tuple(s)

    if name == "embed":
        if shape[0] % tp_size == 0:
            return spec(0, tp)  # vocab-sharded
        if shape[1] % tp_size == 0:
            return spec(1, tp)  # fallback: d_model-sharded
        return tuple(none)
    if name in ("w_gate", "w_up", "w_down") and len(shape) == 3 + off:
        # MoE expert weights (L, E, d, f) / (L, E, f, d)
        E = shape[off]
        if E % tp_size == 0:
            return spec(off, tp)  # EP
        # shard the per-expert hidden dim instead
        h_idx = len(shape) - 1 if name != "w_down" else len(shape) - 2
        if shape[h_idx] % tp_size == 0:
            return spec(h_idx, tp)
        return tuple(none)
    if name in _COL_PARALLEL:
        if shape[-1] % tp_size == 0:
            return spec(len(shape) - 1, tp)
        return tuple(none)
    if name in _ROW_PARALLEL:
        if shape[-2] % tp_size == 0:
            return spec(len(shape) - 2, tp)
        return tuple(none)
    return tuple(none)  # norms, routers, ssm (replicated base), biases


def _zero_extend(spec: Spec, shape: Tuple[int, ...], dp: Tuple[str, ...],
                 dp_size: int) -> Spec:
    """ZeRO/FSDP: shard the largest still-unsharded dim over the data axes."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is None and shape[i] % dp_size == 0 and shape[i] >= dp_size:
            entries[i] = dp if len(dp) > 1 else dp[0]
            return tuple(entries)
    return tuple(entries)


# Models below this many params are replicated in training (pure DP):
# FSDP-gathering a 130M model costs more wire traffic than it saves memory.
REPLICATE_BELOW = 5e8


def ep_axes(mesh) -> Tuple[str, ...]:
    """Expanded expert-parallel axes: innermost data axis x model axis."""
    ax = MeshAxes.from_mesh(mesh)
    return (ax.dp[-1], ax.tp)


def _leaf_name(path: Tuple[str, ...]) -> str:
    return path[-1] if path else ""


def _stacked(path: Tuple[str, ...]) -> bool:
    return any(seg.startswith("seg") or seg in ("encoder", "cross") for seg in path)


def _param_rule(cfg: ModelConfig, mesh, *, zero: bool = True, mode: str = "train"
                ) -> Callable:
    """``rule(path, leaf)``: the spec of one leaf (a tensor or a shape) at
    ``path`` under :func:`param_pspecs`."""
    ax = MeshAxes.from_mesh(mesh)
    tp_size = _axis_size(mesh, ax.tp)
    dp_size = _dp_size(mesh, ax)
    if mode == "serve":
        serve_axes = ax.dp + (ax.tp,)
        serve_size = dp_size * tp_size
    replicate = (mode == "train" and zero and cfg.param_count() < REPLICATE_BELOW)

    def rule(path, leaf):
        name, shape = _leaf_name(path), _shape(leaf)
        stacked = _stacked(path)
        if replicate:
            return (None,) * len(shape)
        if mode == "serve":
            spec = _base_tp_spec(name, shape, serve_axes, serve_size, stacked, cfg)
            if any(e is not None for e in spec):
                return spec
            # 1-D over all axes didn't divide: shard the matrix 2-D instead --
            # rows over the data axes, cols over the model axis
            if len(shape) >= 2:
                r, c = shape[-2], shape[-1]
                dp_comb = ax.dp if len(ax.dp) > 1 else ax.dp[0]
                entries = [None] * len(shape)
                if r % dp_size == 0 and c % tp_size == 0:
                    entries[-2], entries[-1] = dp_comb, ax.tp
                    return tuple(entries)
                if r % tp_size == 0 and c % dp_size == 0:
                    entries[-2], entries[-1] = ax.tp, dp_comb
                    return tuple(entries)
            # last resort: TP + ZeRO storage
            spec = _base_tp_spec(name, shape, ax.tp, tp_size, stacked, cfg)
            return _zero_extend(spec, shape, ax.dp, dp_size)
        spec = _base_tp_spec(name, shape, ax.tp, tp_size, stacked, cfg)
        if zero:
            spec = _zero_extend(spec, shape, ax.dp, dp_size)
        return spec

    return rule


def param_pspecs(cfg: ModelConfig, mesh, params_shape, *, zero: bool = True,
                 mode: str = "train") -> Any:
    """Spec tree matching ``params_shape``.

    mode="train": Megatron TP + ZeRO/FSDP storage extension over data axes.
    mode="serve": 2-D tensor parallelism over ALL axes -- weights stay
    resident (no per-step FSDP gathers).
    """
    return _map_with_path(_param_rule(cfg, mesh, zero=zero, mode=mode), params_shape)


def opt_pspecs(cfg: ModelConfig, mesh, opt_shape, param_specs) -> Any:
    """Optimizer moments mirror the (ZeRO-extended) parameter specs."""
    return {"m": param_specs, "v": param_specs, "step": ()}


# --------------------------------------------------------------------------
# Batch / cache rules
# --------------------------------------------------------------------------

def batch_pspecs(cfg: ModelConfig, mesh, batch_shape: Dict) -> Dict:
    ax = MeshAxes.from_mesh(mesh)
    dp = ax.dp if len(ax.dp) > 1 else ax.dp[0]
    dp_size = _dp_size(mesh, ax)

    def rule(path, leaf):
        name, shape = _leaf_name(path), _shape(leaf)
        if name == "positions3":  # (3, B, S)
            return (None, dp, None) if shape[1] % dp_size == 0 else ()
        if len(shape) == 0:
            return ()
        b = shape[0]
        rest = (None,) * (len(shape) - 1)
        if b % dp_size == 0:
            return (dp,) + rest
        # small batches: shard over the largest dp sub-axis that divides
        for a in sorted(ax.dp, key=lambda a: -_axis_size(mesh, a)):
            if b % _axis_size(mesh, a) == 0 and b >= _axis_size(mesh, a):
                return (a,) + rest
        return (None,) * len(shape)

    return _map_with_path(rule, batch_shape)


def cache_pspecs(cfg: ModelConfig, mesh, cache_shape) -> Any:
    """Decode caches: batch over DP when divisible, sequence over TP (SP);
    tiny leaves (SSM states, ring buffers) fall back sensibly."""
    ax = MeshAxes.from_mesh(mesh)
    tp_size = _axis_size(mesh, ax.tp)
    dp_size = _dp_size(mesh, ax)
    dp = ax.dp if len(ax.dp) > 1 else ax.dp[0]

    def rule(path, leaf):
        name, shape = _leaf_name(path), _shape(leaf)
        entries = [None] * len(shape)
        if name in ("k", "v", "ckv", "krope", "pos"):
            # (L, B, S, ...) -- stacked per segment
            b_idx, s_idx = 1, 2
            if shape[b_idx] % dp_size == 0:
                entries[b_idx] = dp
                if shape[s_idx] % tp_size == 0:
                    entries[s_idx] = ax.tp
            else:
                # batch too small (long_500k): full sequence parallelism
                flat = ax.dp + (ax.tp,)
                total = dp_size * tp_size
                if shape[s_idx] % total == 0:
                    entries[s_idx] = flat
                elif shape[s_idx] % tp_size == 0:
                    entries[s_idx] = ax.tp
            return tuple(entries)
        if name in ("state", "conv"):  # SSM: (L, B, ...)
            if shape[1] % dp_size == 0:
                entries[1] = dp
            return tuple(entries)
        return tuple(entries)

    return _map_with_path(rule, cache_shape)


def paged_cache_pspecs(cfg: ModelConfig, mesh, cache_shape=None) -> Any:
    """Spec tree for the engine's **L-stacked paged cache pools** (the
    ``init_paged_cache`` tree: ``seg{i} -> adapter.key -> pool leaf``).

    Placement is each family's cache adapter's business
    (:meth:`repro_torch.models.adapters.CacheAdapter.pool_pspecs`): dense/GQA
    and ring/cross pools shard their kv-head axis over the model axis when
    it divides; MLA latent pools replicate (no head axis); SSM state rows
    replicate.  Page tables and free lists are host-side and never enter
    this tree.  Without ``cache_shape`` the leaf names come from each
    adapter's pool allocated on the ``meta`` device (no memory).
    """
    from repro_torch.models import adapters as A

    ax = MeshAxes.from_mesh(mesh)
    tp_size = _axis_size(mesh, ax.tp)

    def leaf_names(si: int, ad) -> Tuple[str, ...]:
        if cache_shape is not None:
            return tuple(cache_shape[f"seg{si}"][ad.key])
        geom = A.CacheGeometry(max_seqs=1, num_pages=2, page_size=cfg.block,
                               max_len=cfg.block)
        return tuple(ad.init_pool(cfg, geom, device=torch.device("meta")))

    out: Dict[str, Any] = {}
    for si, (kind, _n) in enumerate(A.layer_segments(cfg)):
        seg: Dict[str, Any] = {}
        for ad in A.adapters_for(cfg, kind):
            specs = ad.pool_pspecs(cfg, tp_axis=ax.tp, tp_size=tp_size)
            seg[ad.key] = {name: specs.get(name, ()) for name in leaf_names(si, ad)}
        out[f"seg{si}"] = seg
    return out


def validate_paged_sharding(cfg: ModelConfig, mesh) -> None:
    """Reject (config, mesh) pairs whose paged K/V head axis cannot shard.

    Called at :class:`~repro_torch.serve.engine.Engine` construction so a
    non-dividing head count fails fast with an actionable message instead
    of silently replicating the pools.  Families without a head-axis pool
    (MLA latent, SSM rows) pass -- their pools replicate by design.
    """
    from repro_torch.models import adapters as A

    ax = MeshAxes.from_mesh(mesh)
    tp_size = _axis_size(mesh, ax.tp)
    if tp_size <= 1:
        return
    uses_paged_heads = any(
        isinstance(ad, A.PagedAttnAdapter) for ad in A.all_adapters(cfg)
    )
    if uses_paged_heads and cfg.n_kv_heads % tp_size:
        divisors = [m for m in range(1, cfg.n_kv_heads + 1) if cfg.n_kv_heads % m == 0]
        raise ValueError(
            f"{cfg.name}: n_kv_heads={cfg.n_kv_heads} is not divisible by "
            f"the mesh's model-axis size {tp_size}, so the paged K/V pools "
            f"cannot head-shard (they would silently replicate on every "
            f"device).  Pick a mesh whose model axis divides n_kv_heads "
            f"(valid TP sizes: {divisors}) or serve single-device."
        )


def serve_shardings(cfg: ModelConfig, mesh, params, cache_shape):
    """The serving specs for one (config, mesh): ``(param specs, pool
    specs, replicated)`` -- the JAX serve mode's weights
    (``param_pspecs(mode="serve")``), the adapter registry's pool placement
    for the L-stacked cache, and the replicated spec ``()`` of every small
    host-fed step input (tokens, positions, page tables, scalars)."""
    return (
        param_pspecs(cfg, mesh, params, mode="serve"),
        paged_cache_pspecs(cfg, mesh, cache_shape),
        (),
    )


# --------------------------------------------------------------------------
# Placement: what each rank of the port holds
# --------------------------------------------------------------------------

# Leaves the JAX serve mode shards but the port keeps whole on every rank.
# wq_a: column-parallel in the rules, but its output (the MLA q-LoRA rank)
# feeds the q RMSNorm, which needs it whole.  The rest are sharded by the
# serve mode's 2-D fallback only (the base rules replicate them): norms and
# biases of stacked layers, the MoE router, MLA's wkv_a (its output is the
# latent c_kv, normalised whole and shared by every head), every SSM leaf,
# the enc-dec position tables, the MTP projection.  They are small beside
# the sharded leaves, and each rank computes them identically.
KEPT_WHOLE = ("wq_a",)

# An attention's products: split on whole heads, or kept whole together.
_ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "wq_b", "wkv_b")


def whole_leaves(cfg: ModelConfig, tp_size: int) -> Tuple[str, ...]:
    """The leaf names each rank runs whole on a model axis of ``tp_size``:
    :data:`KEPT_WHOLE`, and every attention projection where the axis does
    not split the query heads (or, for GQA, the kv heads) into whole heads.
    The JAX rules shard such a projection by columns and GSPMD serves the
    rest; a rank here runs every head of it and skips its sum, while the
    other products stay sharded."""
    # a latent-KV attention (kv_lora_rank > 0) has no kv-head projections
    kv = cfg.n_kv_heads % tp_size if not cfg.kv_lora_rank else 0
    if tp_size > 1 and cfg.n_heads and (cfg.n_heads % tp_size or kv):
        return KEPT_WHOLE + _ATTN_LEAVES
    return KEPT_WHOLE


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def split_ways(spec: Spec, sizes: Dict[str, int]) -> int:
    """How many ranks' shares make up a leaf placed by ``spec`` on a mesh
    of axis ``sizes``: the product of the sizes of every axis it names."""
    return math.prod(sizes[a] for entry in spec for a in _entry_axes(entry))


def global_nbytes(tree, specs, mesh) -> int:
    """The bytes of the global arrays whose local shares ``tree`` holds,
    each leaf placed by its spec in ``specs`` (a tree of the same keys)."""
    sizes = mesh_shape(mesh)
    total = 0

    def add(path, leaf):
        nonlocal total
        total += leaf.numel() * leaf.element_size() * split_ways(_get(specs, path), sizes)

    _map_with_path(add, tree)
    return total


def shard_index(shape: Tuple[int, ...], spec: Spec, mesh, coords=None) -> Tuple[slice, ...]:
    """The slice of each dim of a full ``shape`` that a rank at ``coords``
    (default: the mesh's own) holds under ``spec``: a dim whose entry names
    axes is split evenly over the product of their sizes, the first axis
    major (a ``NamedSharding``'s device order)."""
    sizes = mesh_shape(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    index = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            index.append(slice(0, dim))
            continue
        n, pos = 1, 0
        for a in _entry_axes(entry):
            n *= sizes[a]
            pos = pos * sizes[a] + coords[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways under spec {spec}")
        step = dim // n
        index.append(slice(pos * step, (pos + 1) * step))
    return tuple(index)


def local_shard(tensor: torch.Tensor, spec: Spec, mesh, coords=None) -> torch.Tensor:
    """This rank's slice of a full ``tensor`` under ``spec``
    (:func:`shard_index`).  Returns a view (the caller copies it)."""
    return tensor[shard_index(tuple(tensor.shape), spec, mesh, coords)]


def _model_major(entry, sizes: Dict[str, int]):
    """A spec entry as the serve layout stores it: axes of one rank
    dropped, and an entry of several axes led by ``"model"`` (model-major
    blocks)."""
    axes = [a for a in _entry_axes(entry) if sizes[a] > 1]
    axes.sort(key=lambda a: a != "model")
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def _target_rule(cfg: ModelConfig, mesh) -> Callable:
    """``rule(path, leaf)``: the spec of what the ``1 x M`` port reads of a
    leaf -- the base TP rules over the model axis, :func:`whole_leaves`
    whole."""
    tp_size = _axis_size(mesh, "model")
    whole = whole_leaves(cfg, tp_size)

    def rule(path, leaf):
        name, shape = _leaf_name(path), _shape(leaf)
        if name in whole:
            return (None,) * len(shape)
        return _base_tp_spec(name, shape, "model", tp_size, _stacked(path), cfg)

    return rule


def _serve_rule(cfg: ModelConfig, mesh) -> Callable:
    """``rule(path, leaf)``: the spec a serving rank stores a leaf by --
    whole where the ``1 x M`` port reads it whole, else the JAX serve spec
    with its entries model-major (:func:`_model_major`)."""
    sizes = mesh_shape(mesh)
    target, jax_rule = _target_rule(cfg, mesh), _param_rule(cfg, mesh, mode="serve")

    def rule(path, leaf):
        want = target(path, leaf)
        if all(e is None for e in want):
            return want
        return tuple(_model_major(e, sizes) for e in jax_rule(path, leaf))

    return rule


def serve_placement(cfg: ModelConfig, mesh, params_shape) -> Any:
    """The spec tree of what each rank of the serving port stores
    (:class:`ServeLayout`): on a ``1 x M`` mesh the base TP rules over the
    model axis, :func:`whole_leaves` whole."""
    return _map_with_path(_serve_rule(cfg, mesh), params_shape)


def check_local_shards(cfg: ModelConfig, mesh, placement) -> None:
    """Refuse a mesh the port cannot serve.  Every product of
    ``placement`` runs: split on whole heads or widths and summed, or whole
    on each rank with no sum (:func:`whole_leaves`).  What cannot run is a
    paged K/V pool whose kv heads the model axis does not split: refused
    by :func:`validate_paged_sharding` with the JAX package's message."""
    from repro_torch.models import adapters as A

    if _axis_size(mesh, "model") > 1 and A.unsupported_reason(cfg) is None:
        validate_paged_sharding(cfg, mesh)  # a config with engine pools


def shard_params(cfg: ModelConfig, params, mesh, device: torch.device) -> Any:
    """The rank's shards of the full ``params`` (on any device), on
    ``device`` (:meth:`ServeLayout.place`)."""
    return ServeLayout(cfg, mesh).place(params, device)


# --------------------------------------------------------------------------
# Training: what each rank stores, and how the model reads it
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's placement on a mesh (the port's ``NamedSharding``): the
    mesh and the spec."""

    mesh: Any
    spec: Spec


def train_placement(cfg: ModelConfig, mesh, params_shape) -> Tuple[Any, Any]:
    """(parameter specs, optimizer-state specs) of the trainer on ``mesh``:
    exactly :func:`param_pspecs` in train mode (TP over ``model``, ZeRO over
    ``data``, everything replicated below :data:`REPLICATE_BELOW`) and
    :func:`opt_pspecs` for the moments."""
    specs = param_pspecs(cfg, mesh, params_shape, mode="train")
    return specs, opt_pspecs(cfg, mesh, None, specs)


def _axis_dim(spec: Spec, axes: Tuple[str, ...]):
    """The dim whose entry names one of ``axes`` (None: no such dim)."""
    for i, e in enumerate(spec):
        if any(a in axes for a in _entry_axes(e)):
            return i
    return None


def gather_full(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf of which ``local`` is this rank's slice under ``spec``,
    on every rank: the ranks at coordinate 0 of each axis the leaf is not
    split on write their slice into zeros, one ``all_reduce`` over the
    default group adds them (exact)."""
    sizes, coords = mesh_shape(mesh), mesh_coords(mesh)
    used = {a for e in spec for a in _entry_axes(e)}
    shape = tuple(n * math.prod(sizes[a] for a in _entry_axes(e))
                  for n, e in zip(local.shape, tuple(spec) + (None,) * local.dim()))
    out = local.new_zeros(shape)
    if all(coords[a] == 0 for a in sizes if a not in used):
        out[shard_index(shape, spec, mesh, coords)] = local
    if math.prod(sizes.values()) > 1:
        dist.all_reduce(out)
    return out


class _Layout:
    """A rank's placement of a parameter tree on a mesh, leaf by leaf as
    the leaves are drawn (:meth:`cut`, :meth:`stack`, :meth:`cut_layer`,
    which ``repro_torch.models.model.init_params(layout=)`` calls) by
    ``rule(path, full shape)``; an :class:`AbstractMesh` (shapes only, at
    ``coords``) places leaves with no group."""

    def __init__(self, cfg: ModelConfig, mesh, coords, rule: Callable):
        self.cfg, self.mesh = cfg, mesh
        self.sizes = mesh_shape(mesh)
        self.coords = mesh_coords(mesh) if coords is None else coords
        self._rule = rule
        self._specs: Dict[Tuple[str, ...], Spec] = {}
        self._full: Dict[Tuple[str, ...], Tuple[int, ...]] = {}

    def _place(self, path, full_shape) -> Spec:
        spec = self._rule(path, full_shape)
        self._specs[path], self._full[path] = spec, tuple(full_shape)
        return spec

    def local_shape(self, path, full_shape) -> Tuple[int, ...]:
        """The shape of the rank's slice of a leaf of ``full_shape``."""
        idx = shard_index(tuple(full_shape), self._place(path, full_shape), self.mesh,
                          self.coords)
        return tuple(sl.stop - sl.start for sl in idx)

    def cut(self, path: Tuple[str, ...], full: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a whole leaf, copied (the caller frees the
        leaf)."""
        spec = self._place(path, tuple(full.shape))
        piece = full[shard_index(tuple(full.shape), spec, self.mesh, self.coords)]
        return piece.clone(memory_format=torch.contiguous_format)

    def stack(self, path, n: int, layer: torch.Tensor) -> torch.Tensor:
        """An empty local stack for ``n`` layers shaped like ``layer``."""
        spec = self._place(path, (n,) + tuple(layer.shape))
        idx = shard_index(self._full[path], spec, self.mesh, self.coords)
        return torch.empty([sl.stop - sl.start for sl in idx], dtype=layer.dtype,
                           device=layer.device)

    def cut_layer(self, path, layer: torch.Tensor, i: int):
        """(index in the local stack, the rank's slice of layer ``i``), or
        (None, None) where the rank holds no part of that layer."""
        idx = shard_index(self._full[path], self._specs[path], self.mesh, self.coords)
        if not idx[0].start <= i < idx[0].stop:
            return None, None
        return i - idx[0].start, layer[idx[1:]]

    def specs(self, tree) -> Any:
        """The spec tree of a parameter tree placed here."""
        return _map_with_path(lambda path, _leaf: self._specs[path], tree)

    def nbytes(self, tree) -> Tuple[int, int]:
        """(the bytes this rank stores of ``tree``, the bytes of its full
        leaves)."""
        from repro_torch import tree as T

        local = sum(x.numel() * x.element_size() for x in T.leaves(tree))
        full = global_nbytes(tree, self.specs(tree), self.mesh)
        return local, full


# The leaves the model computes on as a serving rank stores them, split
# 1/(D*M) a rank: each one's product is summed over every rank, or, a
# column-parallel attention product, gathered over ``data`` into the model
# slice (``wkv_b`` only where its blocks are whole heads).
_FLAT_READ = ("embed", "lm_head", "wq", "wk", "wv", "bq", "bk", "bv", "wq_b", "wo",
              "w_gate", "w_up", "b_up", "w_down")


class ServeLayout(_Layout):
    """One rank's side of a serving mesh ``D x M``: what it stores of each
    leaf (:func:`serve_placement`'s rule, applied as the leaves are drawn
    or to a full tree by :meth:`place`) and how the model reads it.

    The stored bytes of a leaf are its share under the JAX serve spec,
    but for the leaves the ``1 x M`` port reads whole (:func:`whole_leaves`,
    and those the base rules replicate), which every rank keeps whole.  The
    model computes on the ``1/(D*M)`` blocks of :data:`_FLAT_READ` as they
    are (:mod:`repro_torch.distributed.axes`: ``psum`` over every rank,
    ``data_gather`` into the model slice); any other split leaf (the serve
    mode's 2-D fallback or TP plus ZeRO storage) is gathered into what the
    ``1 x M`` port reads before each step (:meth:`plan`,
    :func:`repro_torch.distributed.axes.resident`): the only per-step
    weight gathers, listed by :meth:`gathered`."""

    def __init__(self, cfg: ModelConfig, mesh, coords=None):
        super().__init__(cfg, mesh, coords, _serve_rule(cfg, mesh))
        self._target = _target_rule(cfg, mesh)
        self._jax = _param_rule(cfg, mesh, mode="serve")
        self._groups = None

    @property
    def ranks(self) -> int:
        return math.prod(self.sizes.values())

    def kept_whole(self, path) -> bool:
        """Whether the rank keeps leaf ``path`` whole where the JAX serve
        spec may split it (the ``1 x M`` port reads it whole)."""
        return all(e is None for e in self._target(path, self._full[path]))

    def place(self, params, device: torch.device) -> Any:
        """The rank's tree on ``device`` from either the full ``params``
        (the JAX API; on any device, each leaf cut and copied, so the caller
        may free the full tree; a leaf kept whole that already lives on
        ``device`` is shared) or a tree this layout already placed (its
        leaves as they are, moved to ``device`` where they live elsewhere).
        Refuses a kv-head count the model axis does not split first
        (:func:`check_local_shards`)."""
        from repro_torch.models.model import param_shapes

        check_local_shards(self.cfg, self.mesh, None)
        full = dict(flat_items(param_shapes(self.cfg)))
        cut_any, placed_any = False, False
        for path, leaf in flat_items(params):
            shape = full.get(path, tuple(leaf.shape))
            local = self.local_shape(path, shape)
            if local == shape:
                continue
            if tuple(leaf.shape) == shape:
                cut_any = True
            elif tuple(leaf.shape) == local:
                placed_any = True
            else:
                raise ValueError(f"{'/'.join(path)}: shape {tuple(leaf.shape)} is neither the "
                                 f"full leaf's {shape} nor this rank's share {local}")
        if cut_any and placed_any:
            raise ValueError("params mix full leaves and a rank's shares")

        def cut(path, leaf):
            spec = self._specs[path]
            if placed_any or all(e is None for e in spec):
                return leaf.to(device)
            piece = local_shard(leaf, spec, self.mesh, self.coords)
            if piece.device == device:
                return piece.clone(memory_format=torch.contiguous_format)
            return piece.to(device).contiguous()

        return _map_with_path(cut, params)

    def _use(self, path) -> "AX.LeafUse | None":
        """How the model reads stored leaf ``path``: None as it is, else
        the gathers into the ``1 x M`` port's leaf."""
        sizes = self.sizes
        norm = lambda spec: tuple(_model_major(e, sizes) for e in spec)  # noqa: E731
        stored, want = norm(self._specs[path]), norm(self._target(path, self._full[path]))
        if stored == want:
            return None
        split = [e for e in stored if e is not None]
        every = {a for a, n in sizes.items() if n > 1}
        name = _leaf_name(path)
        flat_ok = name in _FLAT_READ or (name == "wkv_b" and self.cfg.n_heads % self.ranks == 0)
        if flat_ok and len(split) == 1 and set(_entry_axes(split[0])) == every:
            return None
        data_dim = _axis_dim(stored, ("data",))
        stripped = tuple(_model_major(tuple(a for a in _entry_axes(e) if a != "data"), sizes)
                         for e in stored)
        if stripped == want:
            return AX.LeafUse(data_dim=data_dim)
        return AX.LeafUse(data_dim, _axis_dim(stripped, ("model",)), _axis_dim(want, ("model",)))

    def plan(self) -> Dict[str, Any]:
        """The serving policy's plan: per top-level key, a tree of the
        :class:`~repro_torch.distributed.axes.LeafUse` of each stored leaf
        the model cannot read as it is (whole stacks); keys with none, and
        DeepSeek-V3's MTP head (only training reads it), are left out."""
        out: Dict[str, Any] = {}
        for path in self._specs:
            use = self._use(path)
            if use is None or path[0] == "mtp":
                continue
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = use
        return out

    def gathered(self) -> list:
        """The paths of the leaves gathered before each step (``/``-joined)."""
        return ["/".join(path) for key, uses in self.plan().items()
                for path, _use in flat_items(uses, (key,))]

    def policy(self) -> AX.ShardPolicy:
        """The serving policy (collective the first time on a mesh: every
        rank builds its layout's policy at the same point)."""
        if self._groups is None:
            self._groups = AX.axis_groups(self.mesh)
        return AX.make_policy(self.mesh, self.plan(), self._groups)

    def share_nbytes(self, tree) -> int:
        """The bytes a rank stores of ``tree`` (a rank's tree of this
        config) under the JAX serve spec, each leaf kept whole counted
        whole: what :meth:`place` and the draw by shards must leave on the
        rank."""
        from repro_torch.models.model import param_shapes

        shapes = dict(flat_items(param_shapes(self.cfg)))
        total = 0
        for path, leaf in flat_items(tree):
            full = shapes[path]
            self._place(path, full)
            n = math.prod(full) * leaf.element_size()
            if not self.kept_whole(path):
                n //= split_ways(self._jax(path, full), self.sizes)
            total += n
        return total


class TrainLayout(_Layout):
    """One rank's side of the training mesh: the train-mode spec of every
    leaf (:func:`train_placement`'s rule, applied as the leaves are drawn:
    :meth:`cut`, :meth:`stack`, :meth:`cut_layer`), the plan by which the
    model gathers each leaf before use, and the reductions of the step --
    gradients over ``data`` where a leaf is not split there, the global norm
    and the int8 scale over the axes each leaf is split on.

    A ``DeviceMesh`` gets its axes' process groups here (collective: every
    rank builds its layout at the same point); an :class:`AbstractMesh`
    (shapes only, at ``coords``) places leaves and plans, with no group."""

    def __init__(self, cfg: ModelConfig, mesh, coords=None):
        super().__init__(cfg, mesh, coords, _param_rule(cfg, mesh, mode="train"))
        self.whole = whole_leaves(cfg, self.sizes["model"])
        self.groups = None if isinstance(mesh, AbstractMesh) else AX.axis_groups(mesh)

    def shardings(self, tree) -> Any:
        """:class:`Sharding` records of ``tree`` (parameters, or the
        ``(params, opt_state)`` pair, the moments placed as the
        parameters)."""
        def rec(sub):
            return _map_with_path(lambda path, _l: Sharding(self.mesh, self._specs[path]), sub)
        if isinstance(tree, tuple):
            params, opt = tree
            return (rec(params), {"m": rec(opt["m"]), "v": rec(opt["v"]),
                                  "step": Sharding(self.mesh, ())})
        return rec(tree)

    # ---- how the model reads the stored leaves ----

    def plan(self) -> Dict[Any, Any]:
        """The training policy's plan: a :class:`~repro_torch.distributed.
        axes.LeafUse` tree per top-level key (per layer for a stacked key;
        a stacked leaf whose layer axis is split over ``data`` is gathered
        whole first, under the key ``("stack",) + path``)."""
        out: Dict[Any, Any] = {}
        # an axis of one rank splits nothing: no gather over it
        data_axes = tuple(a for a, n in self.sizes.items() if a != "model" and n > 1)
        whole = self.whole if self.sizes["model"] > 1 else ()
        for path, spec in self._specs.items():
            data = _axis_dim(spec, data_axes)
            model = _axis_dim(spec, ("model",)) if path[-1] in whole else None
            if _stacked(path[:1]):  # a leaf stacked per layer
                if data == 0:
                    out[("stack",) + path] = AX.LeafUse(data_dim=0)
                    data = None
                use = AX.LeafUse(None if data is None else data - 1,
                                 None if model is None else model - 1)
            else:
                use = AX.LeafUse(data, model)
            node = out.setdefault(path[0], {})
            for k in path[1:-1]:
                node = node.setdefault(k, {})
            if len(path) == 1:
                out[path[0]] = use
            else:
                node[path[-1]] = use
        return out

    def policy(self, *, rows_split: bool) -> AX.ShardPolicy:
        return AX.make_train_policy(self.mesh, self.plan(), rows_split=rows_split,
                                    groups=self.groups)

    def split_axes(self, tree) -> list:
        """Per leaf of ``tree`` in flatten order: (split over data, split
        over model)."""
        def walk(sub, path):
            if isinstance(sub, dict):  # flatten order: keys sorted
                return [x for k in sorted(sub) for x in walk(sub[k], path + (k,))]
            spec = self._specs[path]
            return [(_axis_dim(spec, ("data",)) is not None,
                     _axis_dim(spec, ("model",)) is not None)]

        return walk(tree, ())

    # ---- the reductions of a step ----

    def reduce_grads(self, params, grads) -> list:
        """Sum over ``data`` the gradients of the leaves not split there
        (the ZeRO gather's backward has summed the others), one bucketed
        fp32 ``all_reduce``; each rank's loss is a share of the global
        loss, so the sum is the global gradient."""
        if self.sizes["data"] == 1:
            return grads
        todo = [i for i, (d, _m) in enumerate(self.split_axes(params)) if not d]
        if todo:
            flat = torch.cat([grads[i].float().reshape(-1) for i in todo])
            dist.all_reduce(flat, group=self.groups["data"])
            out = list(grads)
            for i, piece in zip(todo, flat.split([grads[i].numel() for i in todo])):
                out[i] = piece.reshape(grads[i].shape).to(grads[i].dtype)
            return out
        return grads

    def global_sumsq(self, params, sumsq) -> torch.Tensor:
        """The global sum of squares of a tree of shards, from each leaf's
        local sum ``sumsq`` (flatten order): summed over each axis a leaf is
        split on, once over an axis it is replicated on."""
        parts = torch.zeros(4, dtype=torch.float32, device=sumsq[0].device)
        for s, (d, m) in zip(sumsq, self.split_axes(params)):
            parts[2 * m + d] += s
        # parts: [whole, data-split, model-split, split over both]
        if self.sizes["data"] > 1:
            both = parts[1::2].contiguous()
            dist.all_reduce(both, group=self.groups["data"])
            parts[1::2] = both
        if self.sizes["model"] > 1:
            both = parts[2:].contiguous()
            dist.all_reduce(both, group=self.groups["model"])
            parts[2:] = both
        return parts.sum()

    def global_max(self, values: torch.Tensor) -> torch.Tensor:
        """Per-leaf maxima of shards, as the maxima of the whole leaves (a
        leaf replicated on an axis has one value there)."""
        values = values.contiguous()
        for axis in ("data", "model"):
            if self.sizes[axis] > 1:
                dist.all_reduce(values, op=dist.ReduceOp.MAX, group=self.groups[axis])
        return values


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
