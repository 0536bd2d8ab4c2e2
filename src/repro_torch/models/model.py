# repro: noqa-file RPR004 -- the model math itself dispatches per family;
# the registry rule protects the serving stack, not the layer definitions
"""Model assembly: one functional LM for the families this port serves.

Counterpart of ``repro.models.model`` for dense and MoE stacks with full
GQA, sliding-window GQA or DeepSeek-V3's MLA attention; the other families
are refused with the ROADMAP.md item that ports them
(:func:`repro_torch.models.adapters.unsupported_message`).  The JAX
package's training path (``forward_train``, ``loss_fn``, the MTP head)
waits for ROADMAP.md queue 1 item 25: a DeepSeek-V3 tree carries its
``mtp`` subtree unread.
Layers are grouped into homogeneous *segments*; each segment's parameters
(and caches) are stacked along a leading L axis, as in the JAX package, and
a Python loop over the layers takes the place of ``jax.lax.scan``.  The
JAX package's sharding constraints have no counterpart without a mesh.

Execution modes: ``prefill`` (populate a static cache), ``decode`` (one
token against it), and the serving engine's ``chunk`` (one prompt chunk
into the paged cache) and paged ``decode``.  Cache tensors are updated in
place: the decode and chunk steps return the caches they were given.

Entry points run on the CUDA device unless the caller passes ``device``:
:func:`init_params` and :func:`params_from_numpy` default to ``"cuda"``
and raise without it; the forward functions run where their tensors live.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.encoder import resolve_device
from repro_torch.models import adapters as A
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffnm
from repro_torch.models.common import apply_norm, default_positions, dense_init, norm_init

# Segment structure lives with the cache-adapter registry, re-exported here
# because the whole system addresses it as M.layer_segments.
layer_segments = A.layer_segments


def _require_supported(cfg: ModelConfig) -> None:
    msg = A.unsupported_message(cfg)
    if msg is not None:
        raise NotImplementedError(msg)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so in-place writes reach the stack."""
    return _tree_map(lambda a: a[i], tree)


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
    if kind not in ("dense", "moe"):
        _require_supported(cfg)
        raise NotImplementedError(f"{cfg.name}: no {kind!r} layers in this port")
    p: Dict[str, Any] = {
        "ln1": norm_init(cfg, cfg.d_model, device),
        "attn": _attn_init(generator, cfg, device),
        "ln2": norm_init(cfg, cfg.d_model, device),
    }
    if kind == "moe":
        p["moe"] = ffnm.moe_init(generator, cfg, device=device)
    else:
        p["ffn"] = ffnm.ffn_init(generator, cfg, device=device)
    return p


def _ffn_block(cfg: ModelConfig, kind: str, p: Dict, h2: torch.Tensor) -> torch.Tensor:
    """The layer's FFN or MoE.  The MoE's auxiliary loss is discarded: only
    training reads it (ROADMAP.md queue 1 item 25)."""
    if kind == "moe":
        return ffnm.moe_forward(p["moe"], cfg, h2)[0]
    return ffnm.ffn_forward(p["ffn"], cfg, h2)


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
) -> Tuple[torch.Tensor, Optional[Dict]]:
    if chunk is not None or (mode == "decode" and seq_pos is not None):
        return _layer_forward_engine(
            cfg, kind, p, x, positions, mode=mode, cache=cache,
            pos_offset=pos_offset, seq_pos=seq_pos, page_table=page_table,
            active=active, chunk=chunk,
        )
    new_cache: Dict[str, Any] = {}
    h = apply_norm(cfg, p["ln1"], x)
    forward = attn.mla_forward if cfg.attn_type == "mla" else attn.gqa_forward
    a_out, a_cache = forward(
        p["attn"], cfg, h, positions, mode=mode,
        cache=cache.get("attn") if cache else None, pos_offset=pos_offset,
    )
    if a_cache is not None:
        new_cache["attn"] = a_cache
    x = x + a_out
    h2 = apply_norm(cfg, p["ln2"], x)
    x = x + _ffn_block(cfg, kind, p, h2)
    return x, (new_cache or None)


def _layer_forward_engine(
    cfg: ModelConfig, kind: str, p: Dict, x, positions, *, mode, cache,
    pos_offset, seq_pos, page_table, active, chunk,
):
    """Engine-mode layer step (chunked prefill / per-slot paged decode).

    The cache semantics -- pool layout, slot addressing, chunk scatter,
    decode read, active masking -- live entirely in the family's
    :class:`~repro_torch.models.adapters.CacheAdapter`; this function only
    wires adapter outputs into the residual stream.
    """
    new_cache: Dict[str, Any] = {}
    h = apply_norm(cfg, p["ln1"], x)
    outs = []
    for ad in A.adapters_for(cfg, kind):
        if mode == "chunk":
            out, c_new = ad.chunk(p[ad.param_key], cfg, h, positions, cache[ad.key],
                                  chunk, pos_offset)
        else:
            out, c_new = ad.decode(p[ad.param_key], cfg, h, positions, cache[ad.key],
                                   seq_pos=seq_pos, page_table=page_table, active=active)
        new_cache[ad.key] = c_new
        outs.append(out)
    x = x + outs[0]
    h2 = apply_norm(cfg, p["ln2"], x)
    x = x + _ffn_block(cfg, kind, p, h2)
    return x, new_cache


# --------------------------------------------------------------------------
# Cache init
# --------------------------------------------------------------------------

def _stacked(one: Dict, n: int) -> Dict:
    """``n`` independent copies of a per-layer cache, stacked on a new axis 0."""
    return _tree_map(lambda a: a.unsqueeze(0).expand(n, *a.shape).clone(), one)


def _layer_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int, device=None):
    _require_supported(cfg)
    if cfg.attn_type == "mla":
        return {"attn": attn.mla_cache_init(cfg, batch, max_len, device=device)}
    return {"attn": attn.gqa_cache_init(cfg, batch, max_len, device=device,
                                        window_only=(cfg.attn_type == "swa"))}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Stacked-per-segment static cache for decode."""
    device = resolve_device(device)
    return {
        f"seg{si}": _stacked(_layer_cache_init(cfg, kind, batch, max_len, device), n)
        for si, (kind, n) in enumerate(layer_segments(cfg))
    }


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
                     max_len: int, device=None):
    """Stacked-per-segment decode cache for the continuous-batching engine.

    Each segment's cache is whatever its family's adapters declare (K/V
    pages for GQA, latent pages for MLA): paged pools share physical page
    ids across layers (page ids are pool-wide).
    """
    _require_supported(cfg)
    device = resolve_device(device)
    geom = A.CacheGeometry(max_seqs, num_pages, page_size, max_len)
    segs = {}
    for si, (kind, n) in enumerate(layer_segments(cfg)):
        c = {ad.key: ad.init_pool(cfg, geom, device=device)
             for ad in A.adapters_for(cfg, kind)}
        segs[f"seg{si}"] = _stacked(c, n)
    return segs


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Random parameters with the JAX package's keys, shapes and scales.

    Drawn from ``generator`` (seed 0 on ``device`` when None) on the
    generator's device and placed on ``device`` (default ``"cuda"``; raises
    without CUDA).  The numbers differ from the JAX package's for the same
    seed; parity tests carry the JAX weights across with
    :func:`params_from_numpy`.  Each segment's stack is filled layer by
    layer, so the peak is the stack plus one layer (a one-layer segment is
    its layer, with no copy).  DeepSeek-V3's MTP head is not drawn: only
    training reads it (ROADMAP.md queue 1 item 25).
    """
    _require_supported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, V = cfg.d_model, cfg.padded_vocab
    emb = torch.randn((V, d), generator=generator, dtype=torch.float32,
                      device=generator.device)
    params: Dict[str, Any] = {
        "embed": emb.mul_(0.02).to(device=device, dtype=cfg.dtype),
        "final_norm": norm_init(cfg, d, device),
    }
    del emb
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, d, V, cfg.dtype, scale=0.02, device=device)
    for si, (kind, n) in enumerate(layer_segments(cfg)):
        stack = None
        for i in range(n):
            layer = init_layer(generator, cfg, kind, device)
            if n == 1:
                stack = _tree_map(lambda a: a.unsqueeze(0), layer)
                break
            if stack is None:
                stack = _tree_map(
                    lambda a: torch.empty((n, *a.shape), dtype=a.dtype, device=device), layer)
            for dst, src in zip(_leaves(stack), _leaves(layer)):
                dst[i].copy_(src)
            del layer
        params[f"seg{si}"] = stack
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _to_tensor(x, device) -> torch.Tensor:
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None) -> Dict:
    """Carry the JAX package's parameter pytree (numpy arrays, stacked per
    segment) over to this port, with the same keys, shapes, layouts and
    element types, on ``device`` (default ``"cuda"``; raises without CUDA):
    a MoE router stays fp32 in a bf16 tree, and DeepSeek-V3's ``mtp``
    subtree is carried, unread by serving."""
    device = resolve_device(device)
    return _tree_map(lambda x: _to_tensor(x, device), tree)


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, params, batch: Dict) -> Tuple[torch.Tensor, Any]:
    tokens = batch["tokens"]
    h = params["embed"][tokens.long()]
    positions = default_positions(tokens.shape[0], tokens.shape[1], device=h.device)
    return h, positions


def _run_segments(
    cfg: ModelConfig, params, h, positions, *, mode: str, caches=None,
    pos_offset=0, seq_pos=None, page_table=None, active=None, chunk=None,
):
    """Run each stacked segment layer by layer; returns (h, new_caches).

    In ``prefill`` mode the per-layer caches are stacked into new tensors;
    in the decode and chunk modes each layer writes its share of the
    stacked caches in place and the same tensors come back."""
    _require_supported(cfg)
    new_caches = {}
    for si, (kind, n) in enumerate(layer_segments(cfg)):
        stacked = params[f"seg{si}"]
        cache_seg = caches.get(f"seg{si}") if caches else None
        layer_caches = []
        for i in range(n):
            h, c_new = layer_forward(
                cfg, kind, _tree_index(stacked, i), h, positions,
                mode=mode, cache=_tree_index(cache_seg, i) if cache_seg is not None else None,
                pos_offset=pos_offset, seq_pos=seq_pos, page_table=page_table,
                active=active, chunk=chunk,
            )
            if mode == "prefill":
                layer_caches.append(c_new)
        if mode == "prefill":
            new_caches[f"seg{si}"] = _tree_stack(layer_caches)
        elif mode in ("decode", "chunk"):
            new_caches[f"seg{si}"] = cache_seg
    return h, new_caches


def _lm_logits(cfg: ModelConfig, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ w
    if cfg.padded_vocab != cfg.vocab_size:
        # mask pad columns so logsumexp / sampling never see them
        logits[..., cfg.vocab_size:] = torch.finfo(logits.dtype).min
    return logits


def prefill(cfg: ModelConfig, params, batch: Dict, last_idx: Optional[int] = None):
    """Full-sequence forward that returns (last-position logits, caches).

    ``last_idx`` selects which position's logits to return -- the
    bucketed-prefill path right-pads the prompt to a shared shape and reads
    the logits at the last *real* token (:func:`supports_padded_prefill`).
    """
    h, positions = _embed_inputs(cfg, params, batch)
    h, caches = _run_segments(cfg, params, h, positions, mode="prefill")
    h = h[:, -1:] if last_idx is None else h[:, last_idx:last_idx + 1]
    h = apply_norm(cfg, params["final_norm"], h)
    return _lm_logits(cfg, params, h), caches


def decode_step(cfg: ModelConfig, params, caches, tokens, pos: int):
    """One decode step.  tokens: (B, 1) integer; pos: host int absolute
    position.  Writes the caches in place; returns (logits (B, 1, V), caches)."""
    B = tokens.shape[0]
    h = params["embed"][tokens.long()]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    h, new_caches = _run_segments(
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
    h = params["embed"][tokens.long()]
    positions = seq_pos[:, None]  # (B, 1) per-slot RoPE positions
    h, new_caches = _run_segments(
        cfg, params, h, positions, mode="decode", caches=caches,
        seq_pos=seq_pos, page_table=page_table, active=active,
    )
    h = apply_norm(cfg, params["final_norm"], h)
    return _lm_logits(cfg, params, h), new_caches


def prefill_chunk(cfg: ModelConfig, params, caches, tokens, slot: int, q_off: int,
                  phys_tok, off_tok, table_row, last_idx: int):
    """One prompt chunk of one request against the engine's paged caches.

    ``tokens`` (1, C) are positions ``q_off .. q_off + C`` of one request's
    prompt.  Paged segments scatter the chunk's K/V straight into its
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
    h = params["embed"][tokens.long()]
    positions = (q_off + torch.arange(C, dtype=torch.int32, device=h.device))[None]
    chunk = {
        "slot": slot, "first": q_off == 0, "table_row": table_row,
        "phys_tok": phys_tok, "off_tok": off_tok,
    }
    h, new_caches = _run_segments(
        cfg, params, h, positions, mode="chunk", caches=caches, pos_offset=q_off,
        chunk=chunk,
    )
    h_last = apply_norm(cfg, params["final_norm"], h[:, last_idx:last_idx + 1])
    return _lm_logits(cfg, params, h_last), new_caches
