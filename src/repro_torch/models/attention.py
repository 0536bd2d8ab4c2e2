"""Attention modules, dense/GQA part: full attention with RoPE, its static
cache, and the block-paged KV cache of the serving engine.

Counterpart of the GQA half of ``repro.models.attention``.  Functional
style: ``init`` returns a params dict; :func:`gqa_forward` handles the
three execution modes ``train`` (no cache), ``prefill`` (returns a filled
cache) and ``decode`` (one token against the cache).  The sliding-window
ring cache and MLA wait for their slices (ROADMAP.md queue 1 items 20, 18).

Where the JAX package rebuilds a cache functionally (``dynamic_update_slice``,
``.at[...].set``) and donates the old one, this port writes into the cache
tensors in place and returns the same tensors: the decode steps mutate the
cache they are given.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_backend
from repro_torch.models.common import (
    apply_rope,
    chunked_attention,
    decode_attention,
    dense,
    dense_init,
)


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------

def gqa_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> Dict:
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(generator, d, H * dh, cfg.dtype, device=device),
        "wk": dense_init(generator, d, Hkv * dh, cfg.dtype, device=device),
        "wv": dense_init(generator, d, Hkv * dh, cfg.dtype, device=device),
        "wo": dense_init(generator, H * dh, d, cfg.dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * dh,), dtype=cfg.dtype, device=device)
        p["bk"] = torch.zeros((Hkv * dh,), dtype=cfg.dtype, device=device)
        p["bv"] = torch.zeros((Hkv * dh,), dtype=cfg.dtype, device=device)
    return p


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Static cache for one layer: ``max_len`` token slots per sequence."""
    dh = cfg.d_head
    return {
        "k": torch.zeros((batch, max_len, cfg.n_kv_heads, dh), dtype=cfg.dtype, device=device),
        "v": torch.zeros((batch, max_len, cfg.n_kv_heads, dh), dtype=cfg.dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def _project_qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense(cfg, x, p["wq"])
    k = dense(cfg, x, p["wk"])
    v = dense(cfg, x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    positions,  # (B, S)
    *,
    mode: str = "train",
    cache: Optional[Dict] = None,
    pos_offset: int = 0,  # absolute position of x[:, 0] (decode/prefill)
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full attention.  ``decode`` writes the new token's K/V and position
    label into ``cache`` in place (slot ``pos_offset``) and attends over it;
    ``prefill`` returns a new cache holding the sequence's K/V."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    if mode == "decode":
        assert cache is not None and S == 1
        slot = pos_offset % cache["k"].shape[1]
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["pos"][:, slot] = pos_offset
        out = decode_attention(q, cache["k"], cache["v"], cache["pos"], pos_offset)
        new_cache = cache
    else:
        out = chunked_attention(q, k, v, causal=causal, q_offset=pos_offset,
                                q_chunk=cfg.q_chunk)
        new_cache = None
        if mode == "prefill":
            pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
            new_cache = {"k": k, "v": v, "pos": pos.contiguous()}
    out = out.reshape(B, S, cfg.n_heads * cfg.d_head)
    return dense(cfg, out, p["wo"]), new_cache


# --------------------------------------------------------------------------
# Paged GQA decode (block-paged KV cache, page size = accelerator block)
# --------------------------------------------------------------------------

def paged_cache_init(cfg: ModelConfig, num_pages: int, page_size: int, device=None) -> Dict:
    """One layer's share of the physical page pool.

    Pages are the accelerator-block-sized unit of cache memory (the paper's
    arrangement quantum applied to the KV cache): page ``i`` of this layer
    holds ``page_size`` contiguous token slots.  Physical page ids are shared
    across layers -- a request's page table indexes every layer's pool with
    the same ids.  Page 0 is reserved as the null page (write target for
    inactive slots, gather target for unmapped table entries).
    """
    dh = cfg.d_head
    shape = (num_pages, page_size, cfg.n_kv_heads, dh)
    return {
        "k_pages": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v_pages": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def paged_gather_attend(q, k_pages, v_pages, page_table, seq_pos):
    """The gather->attend oracle read (the ``"reference"`` backend op).

    Gathers each slot's logical pages back into a dense (B, max_pages*page,
    Hkv, dh) buffer and runs the same masked one-token attention as the
    linear cache -- keys beyond ``seq_pos`` (tail of a partial page, unmapped
    null-page entries, stale pages of retired requests) sit at positions
    above it and mask exactly like empty slots.
    """
    B = q.shape[0]
    page, hkv, dh = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    maxp = page_table.shape[1]
    table = page_table.long()
    kg = k_pages[table].reshape(B, maxp * page, hkv, dh)
    vg = v_pages[table].reshape(B, maxp * page, hkv, dh)
    # gathered keys sit at their absolute positions by construction
    k_positions = torch.arange(maxp * page, device=q.device)[None].expand(B, maxp * page)
    return decode_attention(q, kg, vg, k_positions, seq_pos, window=None)


def gqa_paged_decode(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d) -- one token per slot
    positions: torch.Tensor,  # (B, 1) per-slot absolute positions (RoPE)
    cache: Dict,  # {"k_pages", "v_pages"} (num_pages, page, Hkv, dh)
    page_table: torch.Tensor,  # (B, max_pages) int32 physical page per logical page
    seq_pos: torch.Tensor,  # (B,) int32 absolute position of the new token
    active: Optional[torch.Tensor] = None,  # (B,) bool slots actually decoding
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the block-paged cache.

    Write: the new K/V lands in page ``page_table[b, pos // page]`` at offset
    ``pos % page``.  Read: through ``cfg.decode_backend`` -- the reference
    backend gathers each slot's logical pages back into order
    (:func:`paged_gather_attend`); the cuda backend walks the page-table
    row through the paged-decode kernel without materialising the gathered
    history.

    ``active`` marks slots whose write should land: inactive slots (idle,
    or mid-way through a chunked prefill -- whose page table rows are live!)
    are routed to the reserved null page so the lockstep batch step cannot
    corrupt state it does not own.
    """
    B, S, _ = x.shape
    assert S == 1
    q, k, v = _project_qkv(p, cfg, x, positions)
    page = cache["k_pages"].shape[1]
    pos = seq_pos.long()
    logical = pos // page  # (B,) logical page of the new token
    phys = torch.gather(page_table.long(), 1, logical[:, None])[:, 0]
    if active is not None:
        phys = torch.where(active, phys, 0)  # null page absorbs idle writes
    off = pos % page
    # JAX's functional .at[phys, off].set becomes an in-place index_put_
    # into the pool.  Every inactive slot writes (0, off) -- several may hit
    # the same null-page row, and the CUDA order of duplicate writes is
    # undefined.  That is harmless only because page 0 is never read
    # unmasked: page-table entries that point at it lie past their slot's
    # seq_pos (or belong to an inactive slot, whose output is discarded).
    cache["k_pages"].index_put_((phys, off), k[:, 0])
    cache["v_pages"].index_put_((phys, off), v[:, 0])
    be = resolve_backend(cfg.decode_backend)
    out = be.paged_attention_decode(q, cache["k_pages"], cache["v_pages"], page_table,
                                    seq_pos)
    out = out.reshape(B, 1, cfg.n_heads * cfg.d_head)
    return dense(cfg, out, p["wo"]), cache


def paged_copy_page(cache: Dict, src: int, dst: int) -> Dict:
    """Copy one physical page (``src`` -> ``dst``) in every page pool, in place.

    The copy-on-write step for shared-prefix serving: when a slot must write
    into a page whose refcount is > 1 (aliased by other requests or pinned
    by the prefix index), the host allocates a fresh page, this copy runs,
    and the slot's page-table entry is swapped to the private copy.  Works on
    any pool whose leaves are ``(L, num_pages, page, ...)`` (the page axis
    is axis 1 after the layer stack).

    This sliced copy is the ``"reference"`` backend's op; the cuda backend
    replaces it with the paged-copy kernel
    (:func:`repro_torch.kernels.paged_attention.paged_copy`) -- bit-exact
    either way.
    """
    for pool in cache.values():
        if src != dst:
            pool[:, dst].copy_(pool[:, src])
    return cache


def gqa_paged_prefill_chunk(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (1, C, d) -- one prompt chunk for one slot
    positions: torch.Tensor,  # (1, C) absolute positions q_off + [0, C)
    cache: Dict,  # {"k_pages", "v_pages"} (num_pages, page, Hkv, dh)
    table_row: torch.Tensor,  # (max_pages,) this slot's page table row
    phys_tok: torch.Tensor,  # (C,) physical page per chunk token
    off_tok: torch.Tensor,  # (C,) in-page offset per chunk token
    q_off: int,  # absolute position of x[:, 0]
) -> Tuple[torch.Tensor, Dict]:
    """One prompt chunk against the block-paged cache (prefix-conditioned).

    Write first: the chunk's K/V scatters straight into its physical pages
    (per-token ``(phys, off)`` targets; tokens past the slot's allocation,
    and positions served from aliased prefix pages, are routed to the null
    page by the host -- duplicate null-page writes are harmless for the
    reason :func:`gqa_paged_decode` gives).  Then gather the slot's whole
    page table back into logical order -- the prefix written by earlier
    chunks AND this chunk's own keys -- and run the same causal masked
    attention as full prefill, keys in ascending position order.
    """
    B, C, _ = x.shape
    assert B == 1
    q, k, v = _project_qkv(p, cfg, x, positions)
    phys, off = phys_tok.long(), off_tok.long()
    cache["k_pages"].index_put_((phys, off), k[0])
    cache["v_pages"].index_put_((phys, off), v[0])
    page = cache["k_pages"].shape[1]
    maxp = table_row.shape[0]
    row = table_row.long()
    kg = cache["k_pages"][row].reshape(1, maxp * page, cfg.n_kv_heads, cfg.d_head)
    vg = cache["v_pages"][row].reshape(1, maxp * page, cfg.n_kv_heads, cfg.d_head)
    kpos = torch.arange(maxp * page, dtype=torch.int32, device=x.device)[None]
    out = chunked_attention(q, kg, vg, causal=True, q_offset=q_off, k_positions=kpos,
                            q_chunk=cfg.q_chunk)
    out = out.reshape(B, C, cfg.n_heads * cfg.d_head)
    return dense(cfg, out, p["wo"]), cache
