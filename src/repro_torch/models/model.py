# repro: noqa-file RPR004 -- the model math itself dispatches per family;
# the registry rule protects the serving stack, not the layer definitions
"""Model assembly: one functional LM for the families this port serves.

Counterpart of ``repro.models.model`` for dense and MoE stacks with full
GQA, sliding-window GQA or DeepSeek-V3's MLA attention, SSM stacks
(mamba2), hybrid attention + SSM stacks (Hymba), the enc-dec family
(whisper: an audio encoder, a decoder with cross-attention and learned
positions) and the vision frontend (Qwen2-VL: image embeddings over the
prompt's prefix, M-RoPE over three position streams; the static path only,
as in the JAX package).
Layers are grouped into homogeneous *segments*; each segment's parameters
(and caches) are stacked along a leading L axis, as in the JAX package, and
a Python loop over the layers takes the place of ``jax.lax.scan``.

Serving on a ``D x M`` mesh (:mod:`repro_torch.distributed`): where the
JAX package pins activation layouts with sharding constraints and leaves
the collectives to GSPMD, each rank here runs the same functions on the
parameter shards it holds, under the engine's shard policy: attention on
the model slice of heads its pools hold (a product split over every rank
gathered over ``data`` first), the FFN on its share of the hidden width,
the MoE on its experts, each summed after the row-parallel product over
the ranks that split it; the vocab-sharded embedding as a masked local
lookup and the logits as vocab slices, each completed by one
``all_reduce``.  The norms, the SSM mixers and everything else outside
those products run replicated, on identical inputs, as the JAX rules leave
them.  Each serving entry first gathers the rare leaf the serve layout
stores in no layout the model computes on (:func:`_resident`).

Training on a ``D x M`` mesh (:class:`repro_torch.train.Trainer` with a
mesh): each rank stores its ZeRO slices and gathers a layer's leaves just
before the layer runs (:func:`repro_torch.distributed.axes.materialize`;
with ``remat`` they live only while the layer runs), the collectives above
run through autograd, and the loss is the rank's share of the global loss:
its tokens' summed cross-entropy over the global token count, and the MoE
auxiliary loss as its share of the global one.

Execution modes: ``train`` (:func:`forward_train` and :func:`loss_fn`: the
LM loss, the MoE auxiliary loss and DeepSeek-V3's MTP head, each layer
recomputed in the backward pass with ``remat``), ``prefill`` (populate a
static cache), ``decode`` (one token against it), and the serving engine's
``chunk`` (one prompt chunk into the paged cache) and paged ``decode``.
Cache tensors are updated in place: the decode and chunk steps return the
caches they were given; ``train`` writes no cache, so autograd can follow
it.

Entry points run on the CUDA device unless the caller passes ``device``:
:func:`init_params` and :func:`params_from_numpy` default to ``"cuda"``
and raise without it; the forward functions run where their tensors live.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core.encoder import resolve_device
from repro_torch.distributed import axes as AX
from repro_torch.distributed.axes import enter, gather_slices, psum, split_place
from repro_torch.distributed.sharding import flat_items
from repro_torch.models import adapters as A
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffnm
from repro_torch.models import ssm as ssmm
from repro_torch.models.common import (
    apply_norm,
    default_positions,
    dense_init,
    device_scalar,
    norm_init,
    take_position,
)

# Segment structure lives with the cache-adapter registry, re-exported here
# because the whole system addresses it as M.layer_segments.
layer_segments = A.layer_segments


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so in-place writes reach the
    stack (or, where a leaf is a list of per-layer tensors, as the train
    step hands them to autograd, the list's ``i``-th)."""
    return _tree_map(lambda a: a[i], tree)


def is_layer_stack(key: str) -> bool:
    """Whether the top-level parameter ``key`` holds leaves stacked per
    layer (the model reads layer ``i`` of each as ``a[i]``)."""
    return key.startswith("seg") or key in ("encoder", "cross")


def _tree_stack(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _attn_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> Dict:
    if cfg.attn_type == "mla":
        return attn.mla_init(generator, cfg, device)
    return attn.gqa_init(generator, cfg, device)


def init_layer(generator: torch.Generator, cfg: ModelConfig, kind: str,
               device=None) -> Dict:
    """One layer: an ``"ssm"`` layer is its norm and SSM only; a
    ``"hybrid"`` layer adds the SSM branch to a dense layer."""
    p: Dict[str, Any] = {"ln1": norm_init(cfg, cfg.d_model, device)}
    if kind == "ssm":
        p["ssm"] = ssmm.ssm_init(generator, cfg, device)
        return p
    p["attn"] = _attn_init(generator, cfg, device)
    if kind == "hybrid":
        p["ssm"] = ssmm.ssm_init(generator, cfg, device)
    p["ln2"] = norm_init(cfg, cfg.d_model, device)
    if kind == "moe":
        p["moe"] = ffnm.moe_init(generator, cfg, device=device)
    else:
        p["ffn"] = ffnm.ffn_init(generator, cfg, device=device)
    return p


def _ffn_block(cfg: ModelConfig, kind: str, p: Dict, h2: torch.Tensor):
    """The layer's FFN or MoE: (out, aux), the MoE's auxiliary loss or 0.0
    for a dense FFN (a float: the serving steps allocate no zero tensor)."""
    if kind == "moe":
        return ffnm.moe_forward(p["moe"], cfg, h2)
    return ffnm.ffn_forward(p["ffn"], cfg, h2), 0.0


def _ssm_mixer(cfg: ModelConfig, p: Dict, h, mode: str, cache: Optional[Dict]):
    """The SSM branch of a static-cache layer: ``decode`` writes the new
    state and conv rows into ``cache["ssm"]`` in place and returns them."""
    state = cache.get("ssm") if cache else None
    if mode == "decode":  # under a decode split the state holds this rank's rows
        out, st = ssmm.ssm_forward(p["ssm"], cfg, AX.rows_take(h), mode=mode, state=state)
        for name, t in st.items():
            state[name].copy_(t)
        return AX.rows_gather(out), state
    return ssmm.ssm_forward(p["ssm"], cfg, h, mode=mode, state=state)


def layer_forward(
    cfg: ModelConfig,
    kind: str,
    p: Dict,
    x: torch.Tensor,
    positions,
    *,
    mode: str,
    cache: Optional[Dict],
    pos_offset=0,
    seq_pos=None,  # (B,) per-slot absolute positions (continuous batching)
    page_table=None,  # (B, max_pages) physical page ids (paged KV cache)
    active=None,  # (B,) bool: slots whose decode writes may land
    chunk: Optional[Dict] = None,  # chunked-prefill context (mode "chunk")
) -> Tuple[torch.Tensor, Optional[Dict], Any]:
    """One layer: (x, its cache or None, the MoE auxiliary loss or 0.0)."""
    if chunk is not None or (mode == "decode" and seq_pos is not None):
        return _layer_forward_engine(
            cfg, kind, p, x, positions, mode=mode, cache=cache,
            pos_offset=pos_offset, seq_pos=seq_pos, page_table=page_table,
            active=active, chunk=chunk,
        )
    new_cache: Dict[str, Any] = {}
    h = apply_norm(cfg, p["ln1"], x)
    if kind == "ssm":
        out, st = _ssm_mixer(cfg, p, h, mode, cache)
        if st is not None:
            new_cache["ssm"] = st
        return x + out, (new_cache or None), 0.0
    forward = attn.mla_forward if cfg.attn_type == "mla" else attn.gqa_forward
    a_out, a_cache = forward(
        p["attn"], cfg, h, positions, mode=mode,
        cache=cache.get("attn") if cache else None, pos_offset=pos_offset,
    )
    if a_cache is not None:
        new_cache["attn"] = a_cache
    if kind == "hybrid":
        s_out, st = _ssm_mixer(cfg, p, h, mode, cache)
        if st is not None:
            new_cache["ssm"] = st
        a_out = 0.5 * (a_out + s_out)  # Hymba: fused parallel heads
    x = x + a_out
    f_out, aux = _ffn_block(cfg, kind, p, apply_norm(cfg, p["ln2"], x))
    return x + f_out, (new_cache or None), aux


def _layer_forward_engine(
    cfg: ModelConfig, kind: str, p: Dict, x, positions, *, mode, cache,
    pos_offset, seq_pos, page_table, active, chunk,
):
    """Engine-mode layer step (chunked prefill / per-slot paged decode).

    The cache semantics -- pool layout, slot addressing, chunk scatter,
    decode read, active masking -- live entirely in the family's
    :class:`~repro_torch.models.adapters.CacheAdapter`; this function only
    wires adapter outputs into the residual stream (attention first, the
    hybrid fusion, cross-attention after the self mixer, then FFN/MoE).
    """
    new_cache: Dict[str, Any] = {}
    h = apply_norm(cfg, p["ln1"], x)

    def run(ad, sub_p, hh):
        if mode == "chunk":
            return ad.chunk(sub_p, cfg, hh, positions, cache[ad.key], chunk, pos_offset)
        return ad.decode(sub_p, cfg, hh, positions, cache[ad.key],
                         seq_pos=seq_pos, page_table=page_table, active=active)

    cross = None
    outs = []
    for ad in A.adapters_for(cfg, kind):
        if ad.key == "cross":
            cross = ad  # applies after the self mixer's residual add
            continue
        out, new_cache[ad.key] = run(ad, p[ad.param_key], h)
        outs.append(out)
    if kind == "ssm":
        return x + outs[0], new_cache, 0.0
    # hybrid (Hymba) fuses parallel attention + SSM heads by mean
    x = x + (outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1]))
    if cross is not None:
        hc = apply_norm(cfg, p["cross"]["ln"], x)
        out_c, new_cache["cross"] = run(cross, p["cross"]["attn"], hc)
        x = x + out_c
    f_out, aux = _ffn_block(cfg, kind, p, apply_norm(cfg, p["ln2"], x))
    return x + f_out, new_cache, aux


# --------------------------------------------------------------------------
# Cache init
# --------------------------------------------------------------------------

def _stacked(one: Dict, n: int) -> Dict:
    """``n`` independent copies of a per-layer cache, stacked on a new axis 0."""
    return _tree_map(lambda a: a.unsqueeze(0).expand(n, *a.shape).clone(), one)


def _layer_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int, device=None):
    c: Dict[str, Any] = {}
    if kind in ("dense", "moe", "hybrid"):
        if cfg.attn_type == "mla":
            c["attn"] = attn.mla_cache_init(cfg, batch, max_len, device=device)
        else:
            c["attn"] = attn.gqa_cache_init(cfg, batch, max_len, device=device,
                                            window_only=(cfg.attn_type == "swa"))
    if kind in ("ssm", "hybrid"):
        c["ssm"] = ssmm.ssm_state_init(cfg, batch, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None, tp_size: int = 1):
    """Stacked-per-segment static cache for decode (enc-dec: the decoder's
    cross-attention K/V too, filled at prefill); with ``tp_size`` ranks on
    the model axis, a rank's share of the kv heads (MLA latents and SSM
    rows whole, as the engine pools' specs place them)."""
    device = resolve_device(device)
    rank_cfg, cross_cfg = A.static_cache_cfgs(cfg, tp_size)
    segs = {
        f"seg{si}": _stacked(_layer_cache_init(rank_cfg, kind, batch, max_len, device), n)
        for si, (kind, n) in enumerate(layer_segments(cfg))
    }
    if cfg.n_encoder_layers:
        shape = (cfg.n_layers, batch, cfg.encoder_seq, cross_cfg.n_kv_heads, cfg.d_head)
        segs["seg0"]["cross"] = {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        }
    return segs


def reset_cache(caches) -> None:
    """Set a static cache tree back to :func:`init_cache`'s values, in
    place: every position label to -1 (empty), every other leaf to 0."""
    for tree in caches.values():
        for leaves in tree.values():
            for name, leaf in leaves.items():
                leaf.fill_(-1 if name == "pos" else 0)


def supports_padded_prefill(cfg: ModelConfig) -> bool:
    """Families whose prefill may be right-padded to a bucketed length.

    Full-attention dense/GQA caches index token slots by absolute position
    and mask by position label, so pad keys never survive attention (they
    are causally masked during prefill and overwritten by decode before
    their label becomes reachable) -- padding is bit-exact and lets prompt
    lengths share a handful of power-of-two-page buckets.
    """
    return (
        cfg.attn_type == "full"
        and cfg.family == "dense"
        and cfg.n_encoder_layers == 0
        and cfg.frontend == "none"
        and not cfg.mrope_sections
    )


def init_paged_cache(cfg: ModelConfig, max_seqs: int, num_pages: int, page_size: int,
                     max_len: int, device=None, tp_size: int = 1):
    """Stacked-per-segment decode cache for the continuous-batching engine.

    Each segment's cache is whatever its family's adapters declare (K/V
    pages for GQA, latent pages for MLA, per-slot rows for SWA rings, SSM
    states and enc-dec cross K/V): paged pools share physical page ids
    across layers (page ids are pool-wide).  With ``tp_size`` ranks on the
    model axis, each pool is this rank's share as its adapter's
    ``pool_pspecs`` place it.
    """
    msg = A.unsupported_message(cfg)  # the vision frontend has no cache adapter
    if msg is not None:
        raise NotImplementedError(msg)
    device = resolve_device(device)
    geom = A.CacheGeometry(max_seqs, num_pages, page_size, max_len, tp_size)
    segs = {}
    for si, (kind, n) in enumerate(layer_segments(cfg)):
        c = {ad.key: ad.init_pool(cfg, geom, device=device)
             for ad in A.adapters_for(cfg, kind)}
        segs[f"seg{si}"] = _stacked(c, n)
    return segs


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _rebuild(tree, leaves, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    return leaves[path]


def _draw_device(generator: Optional[torch.Generator], device) -> torch.device:
    """Where a leaf is drawn: on the generator's device, or on ``device``
    (the meta device of :func:`param_shapes`) without one."""
    return device if generator is None else generator.device


@functools.lru_cache(maxsize=16)
def param_shapes(cfg: ModelConfig) -> Dict:
    """The shape tree of :func:`init_params` for ``cfg`` (tuples), from a
    draw on the meta device: no memory and no numbers.  Read it, do not
    change it (the tree is cached per config)."""
    return _tree_map(lambda a: tuple(a.shape), init_params(cfg, device="meta"))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, *, layout=None) -> Dict:
    """Random parameters with the JAX package's keys, shapes and scales.

    Drawn from ``generator`` (seed 0 on ``device`` when None) on the
    generator's device and placed on ``device`` (default ``"cuda"``; raises
    without CUDA); an enc-dec config also draws its encoder, its decoder's
    cross-attention and both learned position tables.  The numbers differ from the JAX package's for the same
    seed; parity tests carry the JAX weights across with
    :func:`params_from_numpy`.  Each segment's stack is filled layer by
    layer, so the peak is the stack plus one layer (a one-layer segment is
    its layer, with no copy).  DeepSeek-V3 also draws its MTP head (``mtp``:
    a projection, two norms, one dense layer and a final norm), which only
    training reads.

    With ``layout`` (a :class:`repro_torch.distributed.sharding.TrainLayout`
    or :class:`~repro_torch.distributed.sharding.ServeLayout`) the draw is
    by shards: the same numbers from the same generator sequence, each leaf
    (each layer of a stack) cut to the rank's slice as it is drawn and the
    whole freed, so the peak is the rank's slices plus one layer (plus one
    whole leaf outside the stacks).  On the meta device the draw takes no
    generator (:func:`param_shapes`).
    """
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)

    def place(key, tree):
        if layout is None:
            return tree
        cut = {path: layout.cut((key,) + path, leaf) for path, leaf in flat_items(tree)}
        return _rebuild(tree, cut)

    d, V = cfg.d_model, cfg.padded_vocab
    emb = torch.randn((V, d), generator=generator, dtype=torch.float32,
                      device=_draw_device(generator, device))
    params: Dict[str, Any] = {"embed": place("embed", emb.mul_(0.02).to(device=device,
                                                                       dtype=cfg.dtype))}
    del emb
    params["final_norm"] = place("final_norm", norm_init(cfg, d, device))
    if not cfg.tie_embeddings:
        params["lm_head"] = place("lm_head", dense_init(generator, d, V, cfg.dtype, scale=0.02,
                                                         device=device))
    for si, (kind, n) in enumerate(layer_segments(cfg)):
        key = f"seg{si}"
        stack = None
        for i in range(n):
            layer = init_layer(generator, cfg, kind, device)
            if layout is not None:
                if stack is None:
                    skeleton = _tree_map(lambda a: None, layer)
                    stack = {path: layout.stack((key,) + path, n, leaf)
                             for path, leaf in flat_items(layer)}
                for path, leaf in flat_items(layer):
                    j, piece = layout.cut_layer((key,) + path, leaf, i)
                    if j is not None:
                        stack[path][j].copy_(piece)
                del layer
                continue
            if n == 1:
                stack = _tree_map(lambda a: a.unsqueeze(0), layer)
                break
            if stack is None:
                stack = _tree_map(
                    lambda a: torch.empty((n, *a.shape), dtype=a.dtype, device=device), layer)
            for dst, src in zip(T.leaves(stack), T.leaves(layer)):
                dst[i].copy_(src)
            del layer
        if layout is not None:
            stack = _rebuild(skeleton, stack)
        params[key] = stack
    if cfg.mtp_depth:
        params["mtp"] = place("mtp", {
            "proj": dense_init(generator, 2 * d, d, cfg.dtype, device=device),
            "norm_h": norm_init(cfg, d, device),
            "norm_e": norm_init(cfg, d, device),
            "layer": init_layer(generator, cfg, "dense", device),
            "final_norm": norm_init(cfg, d, device),
        })
    if cfg.n_encoder_layers:
        params["encoder"] = place("encoder", _tree_stack(
            [_enc_layer_init(generator, cfg, device) for _ in range(cfg.n_encoder_layers)]))
        params["enc_final_norm"] = place("enc_final_norm", norm_init(cfg, d, device))
        params["enc_pos"] = place("enc_pos", _pos_table(generator, cfg, cfg.encoder_seq, device))
        params["cross"] = place("cross", _tree_stack([_cross_init(generator, cfg, device)
                                                      for _ in range(cfg.n_layers)]))
        params["dec_pos"] = place("dec_pos", _pos_table(generator, cfg,
                                                         cfg.max_decoder_positions, device))
    return params


def _pos_table(generator: torch.Generator, cfg: ModelConfig, n: int, device) -> torch.Tensor:
    """A learned position table, N(0, 0.02^2) drawn in fp32."""
    t = torch.randn((n, cfg.d_model), generator=generator, dtype=torch.float32,
                    device=_draw_device(generator, device))
    return t.mul_(0.02).to(device=device, dtype=cfg.dtype)


def _enc_layer_init(generator: torch.Generator, cfg: ModelConfig, device) -> Dict:
    return {
        "ln1": norm_init(cfg, cfg.d_model, device),
        "attn": attn.gqa_init(generator, cfg, device),
        "ln2": norm_init(cfg, cfg.d_model, device),
        "ffn": ffnm.ffn_init(generator, cfg, device=device),
    }


def _cross_init(generator: torch.Generator, cfg: ModelConfig, device) -> Dict:
    return {"ln": norm_init(cfg, cfg.d_model, device),
            "attn": attn.gqa_init(generator, cfg, device)}


def _to_tensor(x, device) -> torch.Tensor:
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None) -> Dict:
    """Carry the JAX package's parameter pytree (numpy arrays, stacked per
    segment) over to this port, with the same keys, shapes, layouts and
    element types, on ``device`` (default ``"cuda"``; raises without CUDA):
    a MoE router and an SSM's ``A_log``, ``D`` and ``dt_bias`` stay fp32 in
    a bf16 tree, whisper's stacked ``encoder`` and ``cross`` subtrees come
    along, and DeepSeek-V3's ``mtp`` subtree is carried (training reads
    it)."""
    device = resolve_device(device)
    return _tree_map(lambda x: _to_tensor(x, device), tree)


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def frontend_extras(cfg: ModelConfig, batch: Dict, B: int, S: int, device) -> Dict:
    """Fill *missing* modality inputs with stubs on ``device``: a vision
    config's zero ``vis_embeds`` (B, n_frontend_tokens, d_model) and
    ``positions3`` of ``arange(S)`` on all three streams, an audio config's
    zero ``audio_embeds`` (B, encoder_seq, d_model).  Inputs already present
    (a request's real image or audio) are left as they are."""
    if cfg.frontend == "vision":
        if "vis_embeds" not in batch:
            batch["vis_embeds"] = torch.zeros((B, cfg.n_frontend_tokens, cfg.d_model),
                                              dtype=cfg.dtype, device=device)
        if "positions3" not in batch:
            batch["positions3"] = torch.arange(S, dtype=torch.int32, device=device)[
                None, None].expand(3, B, S)
    if cfg.frontend == "audio" and "audio_embeds" not in batch:
        batch["audio_embeds"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                            dtype=cfg.dtype, device=device)
    return batch


def _embed_inputs(cfg: ModelConfig, params, batch: Dict) -> Tuple[torch.Tensor, Any]:
    """Token embeddings, the image rows over the first ``vis_embeds.shape[1]``
    of them (a vision config), and the positions: ``positions3`` for an
    M-RoPE config that has them, else ``arange(S)`` per row."""
    tokens = batch["tokens"]
    h = _embed(cfg, params, tokens)
    if cfg.frontend == "vision" and "vis_embeds" in batch:
        v = batch["vis_embeds"].to(h.dtype)
        if v.shape[0] != h.shape[0] or v.shape[1] > h.shape[1] or v.shape[2] != h.shape[2]:
            # the JAX package's dynamic_update_slice refuses the same shapes
            raise ValueError(f"vis_embeds of shape {tuple(v.shape)} do not fit in the "
                             f"prompt's embeddings {tuple(h.shape)}: the image prefix "
                             "must not be longer than the prompt")
        h = torch.cat([v, h[:, v.shape[1]:]], dim=1)  # not in place: autograd follows
    if cfg.mrope_sections and "positions3" in batch:
        positions = batch["positions3"]
    else:
        positions = default_positions(tokens.shape[0], tokens.shape[1], device=h.device)
    return h, positions


def _train_layer(cfg: ModelConfig, kind: str, p: Dict, x, positions, key: str):
    """One training layer; under a training policy its stored leaves
    (``key``'s) are gathered here, inside the recomputed region."""
    p = AX.materialize(p, key)
    x, _, aux = layer_forward(cfg, kind, p, x, positions, mode="train", cache=None)
    return x, aux


def _run_segments(
    cfg: ModelConfig, params, h, positions, *, mode: str, caches=None,
    pos_offset=0, remat: bool = False, seq_pos=None, page_table=None, active=None,
    chunk=None,
):
    """Run each stacked segment layer by layer; returns (h, new_caches,
    aux_sum), the MoE layers' auxiliary losses summed per segment (0.0
    where there is none).

    In ``prefill`` mode the per-layer caches are stacked into new tensors;
    in the decode and chunk modes each layer writes its share of the
    stacked caches in place and the same tensors come back.  ``remat`` (in
    ``train`` mode) keeps only each layer's input for the backward pass and
    recomputes the rest there (``torch.utils.checkpoint``), the counterpart
    of the JAX package's ``jax.checkpoint(nothing_saveable)``."""
    aux_total = 0.0
    new_caches = {}
    engine = chunk is not None or (mode == "decode" and seq_pos is not None)
    # a forward without gradients on the trainer's placement (the dry run's
    # prefill): each layer's stored leaves gathered as training gathers them
    gather = mode != "train" and _training_policy()
    seg_off = 0
    for si, (kind, n) in enumerate(layer_segments(cfg)):
        stacked = params[f"seg{si}"]
        if gather:
            stacked = _whole_stacks(stacked, (f"seg{si}",))
        if engine and cfg.n_encoder_layers:
            # the enc-dec engine path: each decoder layer's cross-attention
            # params ride with it (this segment's share of the stack, as the
            # cross adapter splits its admission install)
            stacked = dict(stacked, cross=_tree_map(lambda a: a[seg_off:seg_off + n],
                                                    params["cross"]))
        seg_off += n
        cache_seg = caches.get(f"seg{si}") if caches else None
        layer_caches, auxes = [], []
        for i in range(n):
            p_layer = _tree_index(stacked, i)
            if mode == "train" and remat:
                h, aux = checkpoint(_train_layer, cfg, kind, p_layer, h, positions,
                                    f"seg{si}", use_reentrant=False)
            elif mode == "train":
                h, aux = _train_layer(cfg, kind, p_layer, h, positions, f"seg{si}")
            else:
                if gather:
                    p_layer = AX.materialize(p_layer, f"seg{si}")
                h, c_new, aux = layer_forward(
                    cfg, kind, p_layer, h, positions,
                    mode=mode, cache=_tree_index(cache_seg, i) if cache_seg is not None else None,
                    pos_offset=pos_offset, seq_pos=seq_pos, page_table=page_table,
                    active=active, chunk=chunk,
                )
                if mode == "prefill":
                    layer_caches.append(c_new)
            if isinstance(aux, torch.Tensor):
                auxes.append(aux)
        if auxes:  # the JAX package sums each segment's stacked aux values
            aux_total = aux_total + torch.stack(auxes).sum()
        if mode == "prefill":
            new_caches[f"seg{si}"] = _tree_stack(layer_caches)
        elif mode in ("decode", "chunk"):
            new_caches[f"seg{si}"] = cache_seg
    return h, new_caches, aux_total


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings.  On a rank holding a vocab slice of ``embed``: the
    rows of the ids in its slice, zeros for the rest, summed over the ranks
    that split the vocab (exact: each id's row comes from one rank); on a
    rank holding a d_model slice: its columns, gathered."""
    emb, ids = params["embed"], tokens.long()
    n, V = emb.shape[0], cfg.padded_vocab
    if n != V:  # vocab-sharded
        ids = ids - split_place(n, V, "embed's vocab rows")[0] * n
        here = (ids >= 0) & (ids < n)
        return psum(emb[ids.clamp(0, n - 1)].masked_fill(~here[..., None], 0), n, V,
                    "embed's vocab rows")
    return gather_slices(emb[ids], cfg.d_model, what="embed's d_model columns")


def _lm_logits(cfg: ModelConfig, params, h):
    """Logits over the padded vocab.  On a rank holding a vocab slice of the
    head (``lm_head``'s columns or, tied, ``embed``'s rows) its slice of the
    logits, gathered; tied to a d_model-sharded ``embed``, the partial
    products summed."""
    if cfg.tie_embeddings and params["embed"].shape[1] != cfg.d_model:
        n = params["embed"].shape[1]
        c0 = split_place(n, cfg.d_model, "embed's d_model columns")[0] * n
        logits = psum(enter(h)[..., c0:c0 + n] @ params["embed"].T, n, cfg.d_model,
                      "embed's d_model columns")
    else:
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        h = enter(h, w.shape[-1] != cfg.padded_vocab)
        logits = gather_slices(h @ w, cfg.padded_vocab, what="the head's vocab columns")
    if cfg.padded_vocab != cfg.vocab_size:
        # mask pad columns so logsumexp / sampling never see them (in place:
        # the product's backward reads its operands, not its output)
        logits[..., cfg.vocab_size:] = torch.finfo(logits.dtype).min
    return logits


def _resident(params):
    """Serving on a mesh: each parameter as the model reads it -- the
    leaves the serve layout stores in no layout the model computes on
    gathered (:func:`repro_torch.distributed.axes.resident`), the rest as
    they are."""
    pol = AX.current()
    if pol is None or pol.train or not pol.plan:
        return params
    return {k: AX.resident(v, k) for k, v in params.items()}


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

def _training_policy() -> bool:
    pol = AX.current()
    return pol is not None and pol.train


def _whole_stacks(tree, path):
    """Each stacked leaf of ``tree`` (at ``path``) whose layer axis the
    training policy's plan splits over the data axes, gathered whole
    (:func:`repro_torch.distributed.axes.gather_stack`); the rest as they
    are."""
    if isinstance(tree, dict):
        return {k: _whole_stacks(v, path + (k,)) for k, v in tree.items()}
    return AX.gather_stack(path, tree)


def _materialize_top(params):
    """The leaves outside the layer stacks (embedding, head, norms, MTP,
    position tables) as the model reads them: gathered under a training
    policy (:func:`repro_torch.distributed.axes.materialize`), else as
    they are."""
    if AX.current() is None:
        return params
    return {k: v if is_layer_stack(k) else AX.materialize(v, k) for k, v in params.items()}


def forward_train(cfg: ModelConfig, params, batch: Dict, *, remat: bool = True):
    """Returns (per-token logits, the summed MoE auxiliary loss, the final
    hidden states)."""
    return _forward_train(cfg, _materialize_top(params), batch, remat=remat)


def _forward_train(cfg: ModelConfig, params, batch: Dict, *, remat: bool = True):
    if cfg.n_encoder_layers:
        return _forward_encdec_train(cfg, params, batch, remat=remat)
    h, positions = _embed_inputs(cfg, params, batch)
    h, _, aux = _run_segments(cfg, params, h, positions, mode="train", remat=remat)
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h = apply_norm(cfg, params["final_norm"], h)
    return _lm_logits(cfg, params, h), aux, h


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the positions with label >= 0, the logsumexp in fp32,
    divided by max(count, 1).  The label's logit is gathered; the JAX
    package takes it by a masked sum over the vocabulary (for a sharded
    vocabulary), which adds it to zeros and gives the same value.  Under a
    training policy with a data axis the count is the global one (summed
    over ``data``), so a rank's value is its share of the global mean --
    never a mean of the ranks' means."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - ll) * mask) / torch.clamp(AX.data_sum(mask.sum()), min=1.0)


def loss_fn(cfg: ModelConfig, params, batch: Dict, *, remat: bool = True):
    """Next-token LM loss (+ the MoE auxiliary loss, + DeepSeek-V3's MTP
    head at weight 0.1); returns (loss, {"ce", "aux"[, "mtp"]})."""
    params = _materialize_top(params)
    if cfg.n_encoder_layers:
        logits, aux, _ = _forward_encdec_train(cfg, params, batch, remat=remat)
        loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
        return loss + aux, {"ce": loss, "aux": aux}
    logits, aux, h = _forward_train(cfg, params, batch, remat=remat)
    labels = batch["labels"]
    loss = cross_entropy(logits[:, :-1], labels[:, :-1])
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp_depth:
        mtp_loss = _mtp_loss(cfg, params, h, batch)
        metrics["mtp"] = mtp_loss
        loss = loss + 0.1 * mtp_loss
    return loss + aux, metrics


def _mtp_loss(cfg: ModelConfig, params, h, batch):
    """DeepSeek-V3 multi-token prediction: one extra dense block predicting
    token t+2 from [h_t ; emb(token_{t+1})], sharing the output head."""
    p = params["mtp"]
    tokens, labels = batch["tokens"], batch["labels"]
    e_next = _embed(cfg, params, tokens[:, 1:])
    comb = torch.cat([apply_norm(cfg, p["norm_h"], h[:, :-1]),
                      apply_norm(cfg, p["norm_e"], e_next)], dim=-1) @ p["proj"]
    positions = default_positions(comb.shape[0], comb.shape[1], device=comb.device)
    out, _, _ = layer_forward(cfg, "dense", p["layer"], comb, positions, mode="train",
                              cache=None)
    logits = _lm_logits(cfg, params, apply_norm(cfg, p["final_norm"], out))
    return cross_entropy(logits[:, :-1], labels[:, 1:-1])  # labels shifted by +1


def _forward_encdec_train(cfg: ModelConfig, params, batch: Dict, *, remat: bool = True):
    """Whisper's training forward: the encoder over ``audio_embeds``, then
    every decoder layer with cross-attention over its output; (logits, a
    zero aux, the final hidden states)."""
    enc_out = _encoder_forward(cfg, params, batch["audio_embeds"], remat=remat)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed(cfg, params, tokens) + params["dec_pos"][None, :S]
    positions = default_positions(B, S, device=h.device)

    def layer(p_layer, p_cross, x):
        p_layer, p_cross = AX.materialize(p_layer, "seg0"), AX.materialize(p_cross, "cross")
        return _dec_layer(cfg, p_layer, p_cross, x, positions, enc_out, mode="train",
                          cache=None, pos_offset=0)[0]

    for i in range(cfg.n_layers):
        args = (_tree_index(params["seg0"], i), _tree_index(params["cross"], i), h)
        h = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
    h = apply_norm(cfg, params["final_norm"], h)
    return _lm_logits(cfg, params, h), torch.zeros((), dtype=torch.float32,
                                                   device=h.device), h


def prefill(cfg: ModelConfig, params, batch: Dict, last_idx=None):
    """Full-sequence forward that returns (last-position logits, caches).

    ``last_idx`` (a host int or a 0-dim int32 device tensor, the JAX
    package's traced scalar) selects which position's logits to return --
    the bucketed-prefill path right-pads the prompt to a shared shape and
    reads the logits at the last *real* token
    (:func:`supports_padded_prefill`).  An enc-dec config reads the batch's
    ``audio_embeds``.
    """
    params = _materialize_top(_resident(params))
    if cfg.n_encoder_layers:
        return _prefill_encdec(cfg, params, batch)
    h, positions = _embed_inputs(cfg, params, batch)
    h, caches, _ = _run_segments(cfg, params, h, positions, mode="prefill")
    h = h[:, -1:] if last_idx is None else take_position(h, last_idx)
    h = apply_norm(cfg, params["final_norm"], h)
    return _lm_logits(cfg, params, h), caches


def decode_step(cfg: ModelConfig, params, caches, tokens, pos):
    """One decode step.  tokens: (B, 1) integer; pos: the absolute position,
    on all three streams of an M-RoPE config (the JAX package's rule) -- a
    0-dim int32 device tensor (the JAX package's traced scalar: no host
    read, so the step can be captured) or a host int (the split paths on a
    mesh need one).  Writes the caches in place; returns (logits (B, 1, V),
    caches)."""
    tokens = AX.rows_gather(tokens)  # under a decode split: every rank's rows
    B = tokens.shape[0]
    params = _resident(params)
    h = _embed(cfg, params, tokens)
    shape = (3, B, 1) if cfg.mrope_sections else (B, 1)
    positions = (pos.to(torch.int32).expand(shape) if isinstance(pos, torch.Tensor)
                 else torch.full(shape, pos, dtype=torch.int32, device=h.device))
    if cfg.n_encoder_layers:
        return _decode_encdec(cfg, params, caches, h, positions, pos)
    h, new_caches, _ = _run_segments(
        cfg, params, h, positions, mode="decode", caches=caches, pos_offset=pos,
    )
    h = apply_norm(cfg, params["final_norm"], h)
    return _lm_logits(cfg, params, h), new_caches


def decode_step_paged(cfg: ModelConfig, params, caches, tokens, seq_pos,
                      page_table, active=None):
    """One continuous-batching decode step (all slots advance together).

    tokens: (B, 1) -- last sampled token per slot (0 for idle slots);
    seq_pos: (B,) int32 -- absolute position the new token occupies (0 idle);
    page_table: (B, max_pages) int32 -- physical page per logical page (idle
    and unmapped entries point at the reserved null page 0);
    active: (B,) bool -- slots actually decoding.  Inactive slots (idle, or
    mid-way through a chunked prefill) run the math but their cache writes
    go to the null page, so the lockstep step cannot corrupt a half-prefilled
    slot.  Returns (logits (B, 1, V), caches), the caches written in place.
    """
    params = _resident(params)
    h = _embed(cfg, params, tokens)
    if cfg.n_encoder_layers:
        # learned decoder positions, gathered per slot (enc-dec decode)
        h = h + params["dec_pos"][seq_pos.long()][:, None]
    positions = seq_pos[:, None]  # (B, 1) per-slot RoPE positions
    h, new_caches, _ = _run_segments(
        cfg, params, h, positions, mode="decode", caches=caches,
        seq_pos=seq_pos, page_table=page_table, active=active,
    )
    h = apply_norm(cfg, params["final_norm"], h)
    return _lm_logits(cfg, params, h), new_caches


def prefill_chunk(cfg: ModelConfig, params, caches, tokens, slot, q_off,
                  phys_tok, off_tok, table_row, last_idx):
    """One prompt chunk of one request against the engine's paged caches.

    ``tokens`` (1, C) are positions ``q_off .. q_off + C`` of one request's
    prompt.  ``slot``, ``q_off`` and ``last_idx`` are 0-dim int32 device
    tensors, as the JAX package traces them (host ints are uploaded first):
    nothing in the step reads them on the host, so one capture serves every
    chunk of a shape.  Paged segments scatter the chunk's K/V straight into its
    physical pages (``phys_tok``/``off_tok``, null-page-routed when past the
    slot's allocation) and attend over the slot's ``table_row`` gather.
    ``caches`` is the engine's full cache tree, written in place, so no
    admission ever copies the pool.

    Returns (logits (1, 1, V) at in-chunk index ``last_idx`` -- the next-
    token distribution after the chunk's last real token, only meaningful
    on the final chunk -- and the caches).
    """
    B, C = tokens.shape
    assert B == 1
    params = _resident(params)
    h = _embed(cfg, params, tokens)
    slot, q_off, last_idx = (device_scalar(x, h.device) for x in (slot, q_off, last_idx))
    positions = (q_off + torch.arange(C, dtype=torch.int32, device=h.device))[None]
    if cfg.n_encoder_layers:
        # learned decoder positions for this chunk's absolute range
        h = h + params["dec_pos"][positions[0].long()][None]
    chunk = {"slot": slot, "table_row": table_row, "phys_tok": phys_tok, "off_tok": off_tok}
    if A.first_chunk_resets(cfg):  # a device bool, made only where an adapter reads it
        chunk["first"] = q_off == 0
    h, new_caches, _ = _run_segments(
        cfg, params, h, positions, mode="chunk", caches=caches, pos_offset=q_off,
        chunk=chunk,
    )
    h_last = apply_norm(cfg, params["final_norm"], take_position(h, last_idx))
    return _lm_logits(cfg, params, h_last), new_caches


# --------------------------------------------------------------------------
# Encoder-decoder (whisper)
# --------------------------------------------------------------------------

def _encoder_forward(cfg: ModelConfig, params, audio_embeds: torch.Tensor, *,
                     remat: bool = False) -> torch.Tensor:
    """The audio encoder: learned positions, non-causal self-attention
    layers (each recomputed in the backward pass with ``remat``), the final
    norm.  (B, encoder_seq, d) in, same shape out."""
    h = audio_embeds.to(cfg.dtype) + params["enc_pos"][None]
    positions = default_positions(h.shape[0], h.shape[1], device=h.device)

    def layer(p, x):
        p = AX.materialize(p, "encoder")
        a, _ = attn.gqa_forward(p["attn"], cfg, apply_norm(cfg, p["ln1"], x), positions,
                                mode="train", causal=False)
        x = x + a
        return x + ffnm.ffn_forward(p["ffn"], cfg, apply_norm(cfg, p["ln2"], x))

    for i in range(cfg.n_encoder_layers):
        p = _tree_index(params["encoder"], i)
        h = checkpoint(layer, p, h, use_reentrant=False) if remat else layer(p, h)
    return apply_norm(cfg, params["enc_final_norm"], h)


def _cross_kv(cfg: ModelConfig, pc: Dict, enc_out: torch.Tensor):
    """One decoder layer's cross-attention K/V over the encoder output."""
    B, S = enc_out.shape[:2]
    enc_out = enter(enc_out, attn.heads_split(pc, cfg))
    kv = cfg.n_kv_heads * cfg.d_head  # the model slice of kv heads, gathered over data
    ck = AX.data_gather(enc_out @ pc["wk"], kv).reshape(B, S, -1, cfg.d_head)
    cv = AX.data_gather(enc_out @ pc["wv"], kv).reshape(B, S, -1, cfg.d_head)
    return ck, cv


def _dec_layer(cfg: ModelConfig, p_layer, p_cross, x, positions, enc_out, *, mode,
               cache, pos_offset):
    """One static-cache decoder layer: causal self-attention, cross-attention
    over the encoder (its K/V from ``cache["cross"]`` in decode), the FFN."""
    new_cache = {}
    h = apply_norm(cfg, p_layer["ln1"], x)
    a, c = attn.gqa_forward(p_layer["attn"], cfg, h, positions, mode=mode,
                            cache=cache.get("attn") if cache else None,
                            pos_offset=pos_offset)
    if c is not None:
        new_cache["attn"] = c
    x = x + a
    hc = apply_norm(cfg, p_cross["ln"], x)
    pc = p_cross["attn"]
    if mode == "decode" and cache is not None and "cross" in cache:
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
    else:
        ck, cv = _cross_kv(cfg, pc, enc_out)
    x = x + attn.cross_attention(pc, cfg, hc, ck, cv)
    x = x + ffnm.ffn_forward(p_layer["ffn"], cfg, apply_norm(cfg, p_layer["ln2"], x))
    return x, new_cache, (ck, cv)


def _prefill_encdec(cfg: ModelConfig, params, batch: Dict):
    if _training_policy():
        params = dict(params, encoder=_whole_stacks(params["encoder"], ("encoder",)))
    enc_out = _encoder_forward(cfg, params, batch["audio_embeds"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed(cfg, params, tokens) + params["dec_pos"][None, :S]
    positions = default_positions(B, S, device=h.device)
    layer_caches = []
    seg, cross = params["seg0"], params["cross"]
    if _training_policy():  # the dry run's prefill on the trainer's placement
        seg, cross = _whole_stacks(seg, ("seg0",)), _whole_stacks(cross, ("cross",))
    for i in range(cfg.n_layers):
        p_layer, p_cross = _tree_index(seg, i), _tree_index(cross, i)
        if _training_policy():
            p_layer, p_cross = AX.materialize(p_layer, "seg0"), AX.materialize(p_cross, "cross")
        h, c_new, (ck, cv) = _dec_layer(
            cfg, p_layer, p_cross, h, positions, enc_out, mode="prefill", cache=None,
            pos_offset=0)
        c_new["cross"] = {"k": ck, "v": cv}
        layer_caches.append(c_new)
    h = apply_norm(cfg, params["final_norm"], h[:, -1:])
    return _lm_logits(cfg, params, h), {"seg0": _tree_stack(layer_caches)}


def _decode_encdec(cfg: ModelConfig, params, caches, h, positions, pos):
    h = h + params["dec_pos"].index_select(0, positions.reshape(-1)[:1])[None]
    for i in range(cfg.n_layers):
        h, _, _ = _dec_layer(
            cfg, _tree_index(params["seg0"], i), _tree_index(params["cross"], i), h,
            positions, None, mode="decode", cache=_tree_index(caches["seg0"], i),
            pos_offset=pos)
    h = apply_norm(cfg, params["final_norm"], h)
    return _lm_logits(cfg, params, h), caches


def encdec_cross_kv(cfg: ModelConfig, params, audio_embeds: torch.Tensor) -> Dict:
    """Encoder forward + every decoder layer's cross K/V projections.

    The continuous-batching engine runs this ONCE per admission and installs
    the result into the slot's immutable cross rows.  Returns stacked
    {"k", "v"} of shape (n_layers, B, encoder_seq, n_kv_heads, d_head).
    """
    params = _resident(params)
    enc_out = _encoder_forward(cfg, params, audio_embeds)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        ck, cv = _cross_kv(cfg, _tree_index(params["cross"], i)["attn"], enc_out)
        ks.append(ck)
        vs.append(cv)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}
