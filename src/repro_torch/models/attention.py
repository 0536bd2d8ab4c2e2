"""Attention modules: GQA (full or sliding-window) with RoPE and MLA
(DeepSeek-V3), their static caches, the block-paged caches of the serving
engine, the sliding-window ring rows and the enc-dec cross-attention.

Counterpart of ``repro.models.attention``.  Functional style: ``init``
returns a params dict; :func:`gqa_forward` and :func:`mla_forward` handle
the three execution modes ``train`` (no cache), ``prefill`` (returns a
filled cache) and ``decode`` (one token against the cache; a ring buffer
for sliding-window attention).  MLA caches the *latent* c_kv + the shared
rotary key and decodes with the absorbed-matmul formulation.  A config with
``mrope_sections`` (Qwen2-VL) rotates q and k by M-RoPE over its (3, B, S)
position streams.

Where the JAX package rebuilds a cache functionally (``dynamic_update_slice``,
``.at[...].set``) and donates the old one, this port writes into the cache
tensors in place and returns the same tensors: the decode steps mutate the
cache they are given.

Serving on a mesh: every function here runs on the heads its weights hold.
Head counts come from the weights' and caches' shapes, never from ``cfg``,
so a rank holding the column-parallel shards of ``wq``/``wk``/``wv``
(``wq_b``/``wkv_b`` for MLA) attends its model slice of heads against its
kv heads (or the whole latent pages), and the row-parallel ``wo`` product
is summed over the ranks that split its rows by
:func:`repro_torch.distributed.axes.psum` (a no-op without a mesh).  On a
data axis of ``D`` ranks a rank holds 1/D of its model slice's columns:
its q/k/v products are gathered over ``data`` into the model slice
(:func:`~repro_torch.distributed.axes.data_gather`), MLA's ``wkv_b``
products run on the rank's part of the heads, and ``wo`` multiplies the
rank's part of the output (:func:`~repro_torch.distributed.axes.data_part`).
Where the model axis does not split the heads whole, each rank holds the
whole attention (:func:`repro_torch.distributed.sharding.whole_leaves`) and
the sum is skipped.  In training, :func:`repro_torch.distributed.axes.enter`
marks where a replicated activation enters the rank's heads, so its
gradient is summed over the model axis.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_backend
from repro_torch.distributed import axes as AX
from repro_torch.distributed.axes import check_split, data_gather, data_part, enter, psum
from repro_torch.models.common import (
    MASK,
    apply_mrope,
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


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None,
                   window_only: bool = False):
    """Static cache for one layer: ``max_len`` token slots per sequence, or
    with ``window_only`` (sliding-window attention) a ring of
    ``min(window, max_len)`` slots.  Empty slots carry position -1."""
    slots = min(cfg.window, max_len) if window_only else max_len
    dh = cfg.d_head
    return {
        "k": torch.zeros((batch, slots, cfg.n_kv_heads, dh), dtype=cfg.dtype, device=device),
        "v": torch.zeros((batch, slots, cfg.n_kv_heads, dh), dtype=cfg.dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32, device=device),
    }


def _write_split_slot(cache: Dict, pos: int, rows: Dict[str, torch.Tensor],
                      ref: str) -> None:
    """Under a decode split: write the new token's ``rows`` (this rank's
    batch rows) and its position label into slot ``pos`` of the cache (a
    ring of the global slots) where this rank holds that slot."""
    place, n = AX.seq_block()
    local = cache[ref].shape[1]
    slot = pos % (local * n)
    if slot // local != place:
        return
    j = slot - place * local
    for name, t in rows.items():
        cache[name][:, j] = t
    cache["pos"][:, j] = pos


def split_decode_attention(q, k_cache, v_cache, k_positions, q_pos: int, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """:func:`~repro_torch.models.common.decode_attention` over this rank's
    block of cache slots under a decode split: the block's scores, their
    maximum over the ranks that split the slots, then the exponentials'
    sums and products with V summed over them (one reduction each); fp32
    throughout, the output in ``v_cache.dtype``."""
    B, Sc, Hkv, Dq = k_cache.shape
    H, Dv = q.shape[2], v_cache.shape[-1]
    g = H // Hkv
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, g, Dq).float(),
                     k_cache.float()) * Dq ** -0.5
    kpos = k_positions.long()
    valid = (kpos >= 0) & (kpos <= q_pos)
    if window is not None:
        valid = valid & (q_pos - kpos < window)
    s = torch.where(valid[:, None, None, :], s, MASK)
    return _split_softmax_product(s, v_cache, "bhgk,bkhd->bhgd").reshape(B, 1, H, Dv)


def _split_softmax_product(s, values, eq: str, seq=None) -> torch.Tensor:
    """softmax(s) (last dim, split over the ranks of the slots: ``seq``,
    default the self-attention caches' split) times ``values`` by ``eq``,
    in ``values.dtype``."""
    m = AX.seq_max(s.amax(-1, keepdim=True), seq)
    p = torch.exp(s - m)
    o = torch.einsum(eq, p, values.float())
    dv = o.shape[-1]
    both = AX.seq_sum(torch.cat([o, p.sum(-1, keepdim=True).expand(*o.shape[:-1], 1)], -1),
                      seq)
    return (both[..., :dv] / both[..., dv:]).to(values.dtype)


def heads_split(p, cfg: ModelConfig) -> bool:
    """Whether ``p`` holds a rank's share of the heads (not all of them)."""
    if "wq_b" in p:  # MLA
        return p["wq_b"].shape[-1] != cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    return p["wq"].shape[-1] != cfg.n_heads * cfg.d_head


def _out_proj(cfg: ModelConfig, out, wo, full: int, mm=None):
    """The row-parallel output projection of ``out`` (B, S, the model
    slice's head outputs): the part the rank's rows of ``wo`` multiply,
    through ``dense`` (or ``mm``), summed over the ranks that split the
    ``full`` rows."""
    part = data_part(out, wo.shape[-2])
    y = dense(cfg, part, wo) if mm is None else mm(part, wo)
    return psum(y, wo.shape[-2], full, "wo's rows")


def _project_qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    dh = cfg.d_head
    x = enter(x, heads_split(p, cfg))
    q = dense(cfg, x, p["wq"])
    k = dense(cfg, x, p["wk"])
    v = dense(cfg, x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = AX.heads_whole(q, cfg.n_heads * dh)
    k = AX.heads_whole(k, cfg.n_kv_heads * dh)
    v = AX.heads_whole(v, cfg.n_kv_heads * dh)
    # the heads the weights hold: all of them, or a rank's share
    q = q.reshape(B, S, -1, dh)
    check_split(q.shape[2], cfg.n_heads, "wq's query heads")
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    if cfg.use_rope:
        if cfg.mrope_sections:  # positions: (3, B, S) position streams
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    positions,  # (B, S), or (3, B, S) for M-RoPE
    *,
    mode: str = "train",
    cache: Optional[Dict] = None,
    pos_offset: int = 0,  # absolute position of x[:, 0] (decode/prefill)
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full or sliding-window attention (an SWA config attends within
    ``cfg.window``).  ``decode`` writes the new token's
    K/V and position label into ``cache`` in place (slot ``pos_offset %
    slots``: a ring for SWA) and attends over it; ``prefill`` returns a new
    cache holding the sequence's K/V -- for SWA its trailing ``min(window,
    S)`` tokens, a full ring in ring order (position p in slot p % window)."""
    B, S, _ = x.shape
    window = cfg.window if cfg.attn_type == "swa" else None  # repro: noqa RPR004 -- the mask's width, not family dispatch
    q, k, v = _project_qkv(p, cfg, x, positions)
    if mode == "decode" and AX.decode_split() is not None:
        assert cache is not None and S == 1
        q, k, v = AX.rows_take(q), AX.rows_take(k), AX.rows_take(v)
        _write_split_slot(cache, pos_offset, {"k": k[:, 0], "v": v[:, 0]}, "k")
        out = AX.rows_gather(split_decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                                    pos_offset, window=window))
        new_cache = cache
    elif mode == "decode":
        assert cache is not None and S == 1
        slot = pos_offset % cache["k"].shape[1]
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["pos"][:, slot] = pos_offset
        out = decode_attention(q, cache["k"], cache["v"], cache["pos"], pos_offset,
                               window=window)
        new_cache = cache
    else:
        out = chunked_attention(q, k, v, causal=causal, q_offset=pos_offset,
                                window=window, q_chunk=cfg.q_chunk)
        new_cache = None
        if mode == "prefill":
            # populate the cache (SWA: keep the trailing ``window`` tokens)
            slots = min(cfg.window, S) if window is not None else S
            ks, vs = k[:, S - slots:], v[:, S - slots:]
            pos = torch.arange(S - slots, S, dtype=torch.int32, device=x.device)
            if window is not None and slots == cfg.window:
                # ring order: the token at absolute position p sits in slot
                # p % window, where later decode steps look for it
                inv = torch.argsort(pos % slots)
                ks, vs, pos = ks[:, inv], vs[:, inv], pos[inv]
            new_cache = {"k": ks, "v": vs, "pos": pos[None].expand(B, slots).contiguous()}
    out = out.reshape(B, S, -1)
    return _out_proj(cfg, out, p["wo"], cfg.n_heads * cfg.d_head), new_cache


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
    out = out.reshape(B, 1, -1)
    return _out_proj(cfg, out, p["wo"], cfg.n_heads * cfg.d_head), cache


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
    kg = cache["k_pages"][row].reshape(1, maxp * page, *cache["k_pages"].shape[2:])
    vg = cache["v_pages"][row].reshape(1, maxp * page, *cache["v_pages"].shape[2:])
    kpos = torch.arange(maxp * page, dtype=torch.int32, device=x.device)[None]
    out = chunked_attention(q, kg, vg, causal=True, q_offset=q_off, k_positions=kpos,
                            q_chunk=cfg.q_chunk)
    out = out.reshape(B, C, -1)
    return _out_proj(cfg, out, p["wo"], cfg.n_heads * cfg.d_head), cache


# --------------------------------------------------------------------------
# Sliding-window ring rows (the serving engine's SWA cache)
# --------------------------------------------------------------------------

def gqa_ring_prefill_chunk(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (1, C, d)
    positions: torch.Tensor,  # (1, C) absolute positions q_off + [0, C)
    cache_row: Dict,  # {"k", "v", "pos"} -- (1, slots, ...) this slot's ring
    q_off: int,  # absolute position of x[:, 0]
    *,
    window: int,
) -> Tuple[torch.Tensor, Dict]:
    """One prompt chunk against the O(window) ring buffer (SWA).

    The prefix is gathered from the ring in **ascending position order**
    (the ring slot of position p is p % slots, so the gather is a
    rotation); empty or reset entries carry position label -1 and mask out.
    Attention then runs over [prefix ; chunk] with the same causal + window
    masking as full prefill, keys in ascending position order.  The chunk's
    trailing min(C, slots) tokens are then written into ``cache_row`` in
    place at their p % slots homes, the layout every later chunk and decode
    step expects; the same row comes back.
    """
    B, C, _ = x.shape
    assert B == 1
    q, k, v = _project_qkv(p, cfg, x, positions)
    slots = cache_row["k"].shape[1]
    # prefix positions q_off - slots .. q_off - 1 in ascending order
    idx = (q_off - slots + torch.arange(slots, device=x.device)) % slots
    keys = torch.cat([cache_row["k"][:, idx], k], dim=1)
    vals = torch.cat([cache_row["v"][:, idx], v], dim=1)
    kpos = torch.cat([cache_row["pos"][:, idx], positions.to(torch.int32)], dim=1)
    out = chunked_attention(q, keys, vals, causal=True, q_offset=q_off, k_positions=kpos,
                            window=window, q_chunk=cfg.q_chunk)
    # persist the chunk's trailing tokens (older ones fall off the ring)
    w = min(C, slots)
    wpos = positions[0, C - w:]  # (w,) distinct ring homes: w <= slots
    widx = wpos.long() % slots
    cache_row["k"][:, widx] = k[:, C - w:].to(cache_row["k"].dtype)
    cache_row["v"][:, widx] = v[:, C - w:].to(cache_row["v"].dtype)
    cache_row["pos"][:, widx] = wpos[None].to(torch.int32)
    out = out.reshape(B, C, -1)
    return _out_proj(cfg, out, p["wo"], cfg.n_heads * cfg.d_head), cache_row


def cross_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over a fixed encoder-side K/V (enc-dec cross).

    The ONE implementation both the static decoder layer and the engine's
    cross adapter call, so their query, softmax and output math cannot
    drift apart.  x: (B, S, d); k, v: (B, encoder_seq, Hkv, dh).
    """
    B, S, _ = x.shape
    q = AX.heads_whole(enter(x, heads_split(p, cfg)) @ p["wq"], cfg.n_heads * cfg.d_head)
    q = q.reshape(B, S, -1, cfg.d_head)
    check_split(q.shape[2], cfg.n_heads, "the cross-attention's query heads")
    if AX.decode_split() is not None:
        out = AX.rows_gather(_split_cross_attend(cfg, AX.rows_take(q), k, v))
    else:
        out = chunked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk)
    return _out_proj(cfg, out.reshape(B, S, -1), p["wo"], cfg.n_heads * cfg.d_head,
                     torch.matmul)


def _split_cross_attend(cfg: ModelConfig, q, k, v):
    """Cross-attention under a decode split: this rank's rows of the cross
    K/V, their encoder positions whole or split as ``cache_pspecs`` places
    them (:func:`repro_torch.distributed.axes.slots_split`)."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    s = torch.einsum("bshgd,bkhd->bhgsk", q.reshape(B, S, Hkv, H // Hkv, dh).float(),
                     k.float()) * dh ** -0.5
    seq = AX.slots_split(k.shape[1], cfg.encoder_seq)
    out = _split_softmax_product(s, v, "bhgsk,bkhd->bhgsd", seq) if seq else \
        torch.einsum("bhgsk,bkhd->bhgsd", torch.softmax(s, -1).to(v.dtype), v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh)


def gqa_ring_decode(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d)
    positions: torch.Tensor,  # (B, 1)
    cache: Dict,  # {"k", "v", "pos"} -- (B, slots, ...) ring buffers
    seq_pos: torch.Tensor,  # (B,) int32 absolute position of the new token
    *,
    window: Optional[int] = None,
    active: Optional[torch.Tensor] = None,  # (B,) bool slots actually decoding
) -> Tuple[torch.Tensor, Dict]:
    """Per-slot-position decode against the O(window) ring buffers (SWA).

    Same layout as the static ring (the token at absolute position p sits in
    slot p % slots), but each batch slot advances on its own, which is what
    continuous batching needs.  The JAX package drops an inactive slot's
    write by scattering it out of bounds; ``index_put_`` raises on such an
    index, so here an inactive row is written back with the value it
    already holds: its ring stays bit for bit as it was, and no host sync
    selects the rows.  Writes the rings in place.
    """
    B, S, _ = x.shape
    assert S == 1
    q, k, v = _project_qkv(p, cfg, x, positions)
    slots = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    slot = seq_pos.long() % slots  # (B,)
    new = {"k": k[:, 0], "v": v[:, 0], "pos": seq_pos.to(torch.int32)}
    for name, val in new.items():
        ring = cache[name]
        val = val.to(ring.dtype)
        if active is not None:
            keep = active.reshape((B,) + (1,) * (val.dim() - 1))
            val = torch.where(keep, val, ring[rows, slot])
        ring[rows, slot] = val
    out = decode_attention(q, cache["k"], cache["v"], cache["pos"], seq_pos, window=window)
    out = out.reshape(B, 1, -1)
    return _out_proj(cfg, out, p["wo"], cfg.n_heads * cfg.d_head), cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# --------------------------------------------------------------------------
# Paged variants live below mla_forward: the engine pages the *latent*
# c_kv + shared rotary key (kv_lora_rank + qk_rope_dim values per token
# instead of 2 * n_kv_heads * d_head) and decodes with the absorbed-matmul
# formulation straight over the latent pages.  The absorption and the value
# expansion are plain products outside any kernel, as in the JAX package.

def mla_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(generator, d, r_q, cfg.dtype, device=device),
        "q_norm": torch.ones((r_q,), dtype=cfg.dtype, device=device),
        "wq_b": dense_init(generator, r_q, H * (dn + dr), cfg.dtype, device=device),
        "wkv_a": dense_init(generator, d, r_kv + dr, cfg.dtype, device=device),
        "kv_norm": torch.ones((r_kv,), dtype=cfg.dtype, device=device),
        "wkv_b": dense_init(generator, r_kv, H * (dn + dv), cfg.dtype, device=device),
        "wo": dense_init(generator, H * dv, d, cfg.dtype, device=device),
    }


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Static cache for one layer: the latent (r_kv) + shared rotary key (dr)."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=cfg.dtype, device=device),
        "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=cfg.dtype,
                             device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def _rms(x, w, eps: float = 1e-6):
    """RMSNorm computed in fp32 and cast back to ``x.dtype``."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def _mla_qkv_latent(p, cfg: ModelConfig, x, positions):
    """Common projections: per-head q (nope + rope), latent ckv, shared k_rope."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    # wq_a, wkv_a and the norms run whole on every rank; their outputs
    # enter the rank's heads
    split = heads_split(p, cfg)
    q = enter(_rms(x @ p["wq_a"], p["q_norm"]), split) @ p["wq_b"]
    q = data_gather(q, cfg.n_heads * (dn + dr))
    q = q.reshape(B, S, -1, dn + dr)  # the model slice of heads
    check_split(q.shape[2], cfg.n_heads, "wq_b's query heads")
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]  # (B, S, r_kv + dr)
    ckv = enter(_rms(kv[..., :cfg.kv_lora_rank], p["kv_norm"]), split)
    k_rope = enter(apply_rope(kv[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                              cfg.rope_theta)[:, :, 0], split)  # (B, S, dr): every head's
    return q_nope, q_rope, ckv, k_rope


# The two MLA attention formulations, each written once: the static-cache
# decode and the paged decode's oracle both reach mla_latent_attend, the
# one-shot prefill and the paged prefill chunk both call
# _mla_expanded_attend, so the engine's parity with the static Server leans
# on math that cannot drift apart.

def mla_latent_attend(q_lat, q_rope, ckv_c, kr_c, valid, *, scale):
    """Latent-space MLA attention (the absorbed formulation's core).

    ``q_lat``: (B, S, H, r) -- q_nope already absorbed through ``W_kv_b``;
    ``valid``: (B, K) key mask.  Returns the latent-space output ``o_lat``
    (B, S, H, r) in ``ckv_c.dtype``; the caller applies the value expansion.
    Scores in fp32; the probabilities are cast to ``ckv_c.dtype`` before the
    product with the latents, as in the JAX package.
    """
    s = torch.einsum("bshr,bkr->bhsk", q_lat.float(), ckv_c.float())
    s = s + torch.einsum("bshd,bkd->bhsk", q_rope.float(), kr_c.float())
    s = torch.where(valid[:, None, None, :], s * scale, MASK)
    att = torch.softmax(s, -1).to(ckv_c.dtype)  # (B, H, S, K)
    return torch.einsum("bhsk,bkr->bshr", att, ckv_c)


def mla_paged_gather_attend(q_lat, q_rope, ckv_pages, krope_pages, page_table, seq_pos, *,
                            scale):
    """The gather->attend oracle over latent pages (the ``"reference"``
    backend op).

    Gathers each slot's latent pages into logical order and scores with
    :func:`mla_latent_attend`; gathered entries sit at their absolute
    positions, so masking by ``k_pos <= seq_pos`` reproduces the linear
    cache's valid set exactly.
    """
    B = q_lat.shape[0]
    page, r_kv = ckv_pages.shape[1], ckv_pages.shape[2]
    maxp = page_table.shape[1]
    table = page_table.long()
    ckv_g = ckv_pages[table].reshape(B, maxp * page, r_kv)
    kr_g = krope_pages[table].reshape(B, maxp * page, -1)
    k_positions = torch.arange(maxp * page, device=q_lat.device)
    valid = k_positions[None] <= seq_pos.long()[:, None]  # (B, K)
    return mla_latent_attend(q_lat, q_rope, ckv_g, kr_g, valid, scale=scale)


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def _wkv_b(p, cfg: ModelConfig):
    """``wkv_b`` as (r_kv, its heads, dn + dv): the model slice of heads or,
    on a data axis, the rank's part of them."""
    return p["wkv_b"].reshape(cfg.kv_lora_rank, -1, cfg.qk_nope_dim + cfg.v_head_dim)


def _mla_out(cfg: ModelConfig, p, out):
    """MLA's output projection of (B, S, heads, dv)."""
    B, S = out.shape[:2]
    return _out_proj(cfg, out.reshape(B, S, -1), p["wo"], cfg.n_heads * cfg.v_head_dim,
                     torch.matmul)


def _mla_absorbed_attend(cfg: ModelConfig, wkv_b, q_nope, q_rope, ckv_c, kr_c, valid):
    """Absorbed-matmul MLA attention over a latent cache.

    score = q_nope . (W_kv_b,k^T c) + q_rope . k_rope
          = (q_nope W_k^T) . c + q_rope . k_rope
    ``valid``: (B, K) key mask.  Returns (B, S, H, v_head_dim).
    """
    dn, H = cfg.qk_nope_dim, wkv_b.shape[1]
    q_nope, q_rope = data_part(q_nope, H, 2), data_part(q_rope, H, 2)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wkv_b[..., :dn])
    o_lat = mla_latent_attend(q_lat, q_rope, ckv_c, kr_c, valid, scale=_mla_scale(cfg))
    return torch.einsum("bshr,rhd->bshd", o_lat, wkv_b[..., dn:])  # value expand


def _mla_split_decode(cfg: ModelConfig, wkv_b, q_nope, q_rope, ckv, k_rope, cache: Dict,
                      pos: int):
    """The absorbed MLA decode under a decode split: the rank's heads of
    ``wkv_b`` absorb its query heads, the latent queries gathered to all
    heads; each rank attends its rows and block of latent slots (the
    blocks combined by :func:`_split_softmax_product`), the latent outputs
    gathered to all rows, its heads expanded and gathered whole for the
    output projection."""
    dn, H, h_here = cfg.qk_nope_dim, cfg.n_heads, wkv_b.shape[1]
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wkv_b[..., :dn])
    q_lat = AX.rows_take(AX.model_gather(q_lat, H, 2))
    q_rope = AX.rows_take(AX.model_gather(q_rope, H, 2))
    _write_split_slot(cache, pos, {"ckv": AX.rows_take(ckv)[:, 0],
                                   "krope": AX.rows_take(k_rope)[:, 0]}, "ckv")
    kpos = cache["pos"].long()
    valid = (kpos >= 0) & (kpos <= pos)
    s = torch.einsum("bshr,bkr->bhsk", q_lat.float(), cache["ckv"].float())
    s = s + torch.einsum("bshd,bkd->bhsk", q_rope.float(), cache["krope"].float())
    s = torch.where(valid[:, None, None, :], s * _mla_scale(cfg), MASK)
    o_lat = _split_softmax_product(s, cache["ckv"], "bhsk,bkr->bhsr").transpose(1, 2)
    o_lat = AX.model_slice(AX.rows_gather(o_lat), h_here, 2)
    out = torch.einsum("bshr,rhd->bshd", o_lat, wkv_b[..., dn:])
    return AX.model_gather(out, H, 2)


def _mla_expanded_attend(cfg: ModelConfig, wkv_b, q_nope, q_rope, ckv, k_rope, *,
                         pos_offset, k_positions=None):
    """Expanded-formulation MLA attention (prefill and prefill chunk).

    Each key position's kv expansion depends only on its own latent, so the
    same call serves contiguous latents and page-gathered ones (with
    ``k_positions`` labelling the gathered order).
    """
    H = wkv_b.shape[1]  # the query heads of wkv_b's part
    q_nope, q_rope = data_part(q_nope, H, 2), data_part(q_rope, H, 2)
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    B, K = ckv.shape[:2]
    kv = torch.einsum("bsr,rhd->bshd", ckv, wkv_b)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, K, H, dr)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    return chunked_attention(q, k, v, causal=True, q_offset=pos_offset,
                             k_positions=k_positions, q_chunk=cfg.q_chunk,
                             scale=_mla_scale(cfg))


def mla_forward(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    positions,  # (B, S)
    *,
    mode: str = "train",
    cache: Optional[Dict] = None,
    pos_offset: int = 0,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA attention.  ``decode`` writes the new token's latent, rotary key
    and position label into ``cache`` in place (slot ``pos_offset``) and
    attends in the absorbed formulation; ``prefill`` returns a new cache
    holding the sequence's latents."""
    B, S, _ = x.shape
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(p, cfg, x, positions)
    wkv_b = _wkv_b(p, cfg)
    if mode == "decode" and AX.decode_split() is not None:
        assert cache is not None and S == 1
        out = _mla_split_decode(cfg, wkv_b, q_nope, q_rope, ckv, k_rope, cache, pos_offset)
        new_cache = cache
    elif mode == "decode":
        assert cache is not None and S == 1
        cache["ckv"][:, pos_offset] = ckv[:, 0]
        cache["krope"][:, pos_offset] = k_rope[:, 0]
        cache["pos"][:, pos_offset] = pos_offset
        valid = (cache["pos"] >= 0) & (cache["pos"] <= pos_offset)
        out = _mla_absorbed_attend(cfg, wkv_b, q_nope, q_rope, cache["ckv"],
                                   cache["krope"], valid)
        new_cache = cache
    else:
        out = _mla_expanded_attend(cfg, wkv_b, q_nope, q_rope, ckv, k_rope,
                                   pos_offset=pos_offset)
        new_cache = None
        if mode == "prefill":
            pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
            new_cache = {"ckv": ckv, "krope": k_rope, "pos": pos.contiguous()}
    return _mla_out(cfg, p, out), new_cache


# --------------------------------------------------------------------------
# Paged MLA (latent pages -- the continuous-batching engine's MLA cache)
# --------------------------------------------------------------------------

def mla_paged_cache_init(cfg: ModelConfig, num_pages: int, page_size: int,
                         device=None) -> Dict:
    """One layer's share of the latent page pool.

    A page holds ``page_size`` token slots of the MLA *latent* cache -- the
    rank-``kv_lora_rank`` c_kv plus the shared ``qk_rope_dim`` rotary key --
    which is all the absorbed-matmul decode ever reads.  Same page-id space
    and null-page discipline as the dense K/V pool.
    """
    return {
        "ckv_pages": torch.zeros((num_pages, page_size, cfg.kv_lora_rank), dtype=cfg.dtype,
                                 device=device),
        "krope_pages": torch.zeros((num_pages, page_size, cfg.qk_rope_dim), dtype=cfg.dtype,
                                   device=device),
    }


def mla_paged_decode(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d) -- one token per slot
    positions: torch.Tensor,  # (B, 1) per-slot absolute positions (RoPE)
    cache: Dict,  # {"ckv_pages", "krope_pages"}
    page_table: torch.Tensor,  # (B, max_pages) int32 physical page per logical page
    seq_pos: torch.Tensor,  # (B,) int32 absolute position of the new token
    active: Optional[torch.Tensor] = None,  # (B,) bool slots actually decoding
) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-matmul decode against the latent page pool.

    Write: the new token's (c_kv, k_rope) lands in its slot's page, in place
    (inactive slots write the null page, as in :func:`gqa_paged_decode`).
    Read: through ``cfg.decode_backend``, always in the absorbed formulation
    -- q_nope is folded into the latent space through ``W_kv_b`` so
    attention runs over rank-r latents, never materialising per-head K/V.
    The reference backend gathers the latent pages into logical order
    (:func:`mla_paged_gather_attend`); the cuda backend walks the page-table
    row through the MLA decode kernel.
    """
    B, S, _ = x.shape
    assert S == 1
    dn = cfg.qk_nope_dim
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(p, cfg, x, positions)
    wkv_b = _wkv_b(p, cfg)
    H = wkv_b.shape[1]  # the query heads of wkv_b's part
    page = cache["ckv_pages"].shape[1]
    pos = seq_pos.long()
    phys = torch.gather(page_table.long(), 1, (pos // page)[:, None])[:, 0]
    if active is not None:
        phys = torch.where(active, phys, 0)  # null page absorbs idle writes
    off = pos % page
    cache["ckv_pages"].index_put_((phys, off), ckv[:, 0])
    cache["krope_pages"].index_put_((phys, off), k_rope[:, 0])
    # the rank's part of the heads absorbed, then (a data axis) gathered
    # into the model slice the kernel runs on; the kernel reads contiguous
    # operands, and einsum may hand back a permuted view
    q_lat = torch.einsum("bshd,rhd->bshr", data_part(q_nope, H, 2), wkv_b[..., :dn])
    q_lat = data_gather(q_lat, cfg.n_heads, dim=2).contiguous()
    be = resolve_backend(cfg.decode_backend)
    o_lat = be.mla_paged_attention_decode(q_lat, q_rope, cache["ckv_pages"],
                                          cache["krope_pages"], page_table, seq_pos,
                                          scale=_mla_scale(cfg))
    out = torch.einsum("bshr,rhd->bshd", data_part(o_lat, H, 2), wkv_b[..., dn:])
    return _mla_out(cfg, p, out), cache


def mla_paged_prefill_chunk(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (1, C, d) -- one prompt chunk for one slot
    positions: torch.Tensor,  # (1, C) absolute positions q_off + [0, C)
    cache: Dict,  # {"ckv_pages", "krope_pages"}
    table_row: torch.Tensor,  # (max_pages,) this slot's page table row
    phys_tok: torch.Tensor,  # (C,) physical page per chunk token
    off_tok: torch.Tensor,  # (C,) in-page offset per chunk token
    q_off: int,  # absolute position of x[:, 0]
) -> Tuple[torch.Tensor, Dict]:
    """One prompt chunk against the latent page pool (prefix-conditioned).

    Write first (per-token latent scatter, in place), then gather the slot's
    whole table row and run the *expanded* formulation over the gathered
    latents -- the same per-position kv expansion and causal masked
    attention as the one-shot prefill, keys in ascending position order.
    The absorbed formulation is kept for decode, where it is the win.
    """
    B, C, _ = x.shape
    assert B == 1
    dr, r_kv = cfg.qk_rope_dim, cfg.kv_lora_rank
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(p, cfg, x, positions)
    wkv_b = _wkv_b(p, cfg)
    phys, off = phys_tok.long(), off_tok.long()
    cache["ckv_pages"].index_put_((phys, off), ckv[0])
    cache["krope_pages"].index_put_((phys, off), k_rope[0])
    page = cache["ckv_pages"].shape[1]
    maxp = table_row.shape[0]
    row = table_row.long()
    ckv_g = cache["ckv_pages"][row].reshape(1, maxp * page, r_kv)
    kr_g = cache["krope_pages"][row].reshape(1, maxp * page, dr)
    kpos = torch.arange(maxp * page, dtype=torch.int32, device=x.device)[None]
    out = _mla_expanded_attend(cfg, wkv_b, q_nope, q_rope, ckv_g, kr_g,
                               pos_offset=q_off, k_positions=kpos)
    return _mla_out(cfg, p, out), cache
