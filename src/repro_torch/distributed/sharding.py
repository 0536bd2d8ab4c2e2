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
tensor by a spec, and the serving engine keeps, on each rank, the shards of
:func:`serve_placement`: the base TP rules over the model axis, which is
where the JAX package's serve mode puts every leaf those rules shard.  The
rest of the JAX serve spec -- its 2-D fallback over ``data x model`` for
norms, routers, SSM weights, ``wkv_a`` and position tables, and ``wq_a``,
whose output the q RMSNorm needs whole (GSPMD gathers it there) -- the port
keeps whole on every rank (:data:`KEPT_WHOLE`).  The training rules are
ported with the rest of this module; the trainer's mesh is not
(ROADMAP.md queue 1 item 26, its training half).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.axes import mesh_coords, mesh_names, mesh_shape

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


def param_pspecs(cfg: ModelConfig, mesh, params_shape, *, zero: bool = True,
                 mode: str = "train") -> Any:
    """Spec tree matching ``params_shape``.

    mode="train": Megatron TP + ZeRO/FSDP storage extension over data axes.
    mode="serve": 2-D tensor parallelism over ALL axes -- weights stay
    resident (no per-step FSDP gathers).
    """
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

    return _map_with_path(rule, params_shape)


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


def local_shard(tensor: torch.Tensor, spec: Spec, mesh, coords=None) -> torch.Tensor:
    """This rank's slice of a full ``tensor`` under ``spec``: a dim whose
    entry names axes is split evenly over the product of their sizes, the
    first axis major (a ``NamedSharding``'s device order), and the slice at
    the rank's ``coords`` (default: the mesh's own) is kept.  Returns a view
    (the caller copies it)."""
    sizes = mesh_shape(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    index = []
    for dim, entry in zip(tensor.shape, tuple(spec) + (None,) * tensor.dim()):
        if entry is None:
            index.append(slice(None))
            continue
        n, pos = 1, 0
        for a in _entry_axes(entry):
            n *= sizes[a]
            pos = pos * sizes[a] + coords[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways under spec {spec}")
        step = dim // n
        index.append(slice(pos * step, (pos + 1) * step))
    return tensor[tuple(index)]


def serve_placement(cfg: ModelConfig, mesh, params_shape) -> Any:
    """The spec tree of what each rank of the serving port holds: the base
    TP rules over the model axis (the JAX serve mode's placement of every
    leaf those rules shard, on a ``1 x M`` mesh), :data:`KEPT_WHOLE` whole."""
    ax = MeshAxes.from_mesh(mesh)
    tp_size = _axis_size(mesh, ax.tp)

    def rule(path, leaf):
        name, shape = _leaf_name(path), _shape(leaf)
        if name in KEPT_WHOLE:
            return (None,) * len(shape)
        return _base_tp_spec(name, shape, ax.tp, tp_size, _stacked(path), cfg)

    return _map_with_path(rule, params_shape)


def check_local_shards(cfg: ModelConfig, mesh, placement) -> None:
    """Refuse a mesh the port cannot run on local heads and widths: every
    rank runs whole attention heads (GQA query and kv heads, MLA query
    heads) and sums every row-parallel product, so each head count and
    each column / row-parallel leaf (``wq_a`` and ``lm_head`` aside) must
    split evenly.  A paged K/V pool's kv heads are refused first, by
    :func:`validate_paged_sharding` with the JAX package's message."""
    from repro_torch.models import adapters as A

    tp = _axis_size(mesh, "model")
    if tp <= 1:
        return
    if A.unsupported_reason(cfg) is None:  # a config with engine pools
        validate_paged_sharding(cfg, mesh)
    names, unsplit = set(), []

    def look(path, spec):
        name = _leaf_name(path)
        names.add(name)
        # a whole embed or lm_head serves as it is (the model gathers only
        # a sliced one); every other column / row-parallel leaf feeds a sum
        if (name in _COL_PARALLEL + _ROW_PARALLEL and name not in KEPT_WHOLE + ("lm_head",)
                and all(e is None for e in spec)):
            unsplit.append("/".join(path))

    _map_with_path(look, placement)
    bad = []
    if cfg.n_heads and cfg.n_heads % tp:
        bad.append(f"n_heads={cfg.n_heads}")
    # the kv heads of the GQA projections that no paged pool holds (SWA
    # rings, cross rows, the static caches; MLA's latent cache has none)
    if "wk" in names and cfg.n_kv_heads % tp:
        bad.append(f"n_kv_heads={cfg.n_kv_heads}")
    bad += unsplit
    if bad:
        raise ValueError(
            f"{cfg.name}: {', '.join(bad)} cannot split over the mesh's model-axis "
            f"size {tp}; each rank of the port runs whole heads and its share of "
            f"every column- and row-parallel product.  Pick a model axis that "
            f"divides them or serve single-device.")


def shard_params(cfg: ModelConfig, params, mesh, device: torch.device) -> Any:
    """The rank's shards of the full ``params`` (on any device), on
    ``device``: each leaf cut by :func:`serve_placement` and copied, so the
    caller may free the full tree; a leaf kept whole that already lives on
    ``device`` is shared, not copied."""
    placement = serve_placement(cfg, mesh, params)
    check_local_shards(cfg, mesh, placement)
    coords = mesh_coords(mesh)

    def cut(path, leaf):
        spec = _get(placement, path)
        if all(e is None for e in spec):
            return leaf.to(device)
        piece = local_shard(leaf, spec, mesh, coords)
        if piece.device == device:
            return piece.clone(memory_format=torch.contiguous_format)
        return piece.to(device).contiguous()

    return _map_with_path(cut, params)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
