# repro: noqa-file RPR004 -- the port's adapter registry: the one place that maps
# layer families to cache layouts (the counterpart of repro/models/adapters.py)
"""CacheAdapter: one paged-cache protocol implementation per layer family.

Counterpart of ``repro.models.adapters``.  The continuous-batching engine
(:mod:`repro_torch.serve`) stores decode context in the units the
accelerator kernel consumes -- pages of ``cfg.block`` token slots.  Each
layer family implements :class:`CacheAdapter`: pool shapes, the prefill
install, the chunked-prefill step, the per-slot decode step, and the
active-mask semantics that keep a lockstep batch step from corrupting slots
it does not own.  The engine, scheduler and model layers drive adapters
generically through :func:`adapters_for` -- this module is the ONLY place
that knows which family uses which cache layout.

This port serves dense and MoE layers with full GQA attention
(:class:`PagedAttnAdapter`, K/V paged), sliding-window GQA
(:class:`RingAttnAdapter`, an O(window) ring row per batch slot) or MLA
(:class:`LatentMLAAdapter`, the latent c_kv + shared rotary key paged); a
MoE layer's cache is its attention's.  SSM layers (mamba2) carry O(1) state
and conv rows per slot (:class:`SSMStateAdapter`), a hybrid layer (Hymba)
its attention's cache and those rows, and an enc-dec decoder (whisper) its
paged self-attention and immutable encoder-side rows
(:class:`CrossAttnAdapter`), installed once at admission.  The vision
frontend has no cache adapter, in the JAX package as here:
:func:`unsupported_message` refuses it for the engine and the paged pool,
and the static ``Server`` serves it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_backend
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssmm


# --------------------------------------------------------------------------
# Segment structure (which layer kinds a config stacks, and how many)
# --------------------------------------------------------------------------

def layer_segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Homogeneous layer groups, each with stacked params."""
    if cfg.family == "ssm":
        return [("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [("hybrid", cfg.n_layers)]
    if cfg.family == "moe":
        segs = []
        if cfg.first_k_dense:
            segs.append(("dense", cfg.first_k_dense))
        segs.append(("moe", cfg.n_layers - cfg.first_k_dense))
        return segs
    return [("dense", cfg.n_layers)]  # dense / vlm / encdec decoder


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """Sizing of the engine's cache pools (tokens are page-granular)."""

    max_seqs: int
    num_pages: int
    page_size: int
    max_len: int
    # the model axis the pools serve: an adapter whose pool specs shard
    # the kv-head axis allocates the rank's 1/tp_size of the heads
    tp_size: int = 1


# --------------------------------------------------------------------------
# Shared slot-row helpers (per-slot, non-paged layouts)
# --------------------------------------------------------------------------

def read_slot_rows(seg_cache: Dict, slot) -> Dict:
    """One batch slot's rows as a (1, ...) dict: views at a host int slot,
    copies (``index_select``) at a 0-dim device tensor, which the chunk step
    gets (no host read of the slot)."""
    if isinstance(slot, torch.Tensor):
        return {k: v.index_select(0, slot.reshape(1)) for k, v in seg_cache.items()}
    return {k: v[slot:slot + 1] for k, v in seg_cache.items()}


def write_slot_rows(seg_cache: Dict, rows: Dict, slot, *, axis: int = 0) -> Dict:
    """Write one slot's rows into the per-slot cache tensors, in place, at a
    host int slot or a 0-dim device tensor (``index_copy_``).

    ``axis`` is the slot axis: 0 inside a layer step, 1 for install into the
    full (L, max_seqs, ...) pools.
    """
    if isinstance(slot, torch.Tensor):
        idx = slot.reshape(1).long()
        for k in seg_cache:
            seg_cache[k].index_copy_(axis, idx, rows[k].to(seg_cache[k].dtype))
        return seg_cache
    index = (slice(None),) * axis + (slice(slot, slot + 1),)
    for k in seg_cache:
        seg_cache[k][index] = rows[k].to(seg_cache[k].dtype)
    return seg_cache


def _first_chunk_reset(row: Dict, first, fill: Dict) -> Dict:
    """``row`` with each named entry set to its ``fill`` value where
    ``first`` (a host bool or a 0-dim device bool) holds: a ``torch.where``
    against the fill value, bit-exact and with no host branch."""
    out = dict(row)
    for name, value in fill.items():
        t = row[name]
        first = torch.as_tensor(first, device=t.device)
        out[name] = torch.where(first, torch.full_like(t, value), t)
    return out


def _install_paged(dst: Dict, src: Dict, phys_tok, off_tok,
                   names: Dict[str, str]) -> Dict:
    """Scatter (L, 1, S, ...)-shaped prefill tensors per token into physical
    pages, in place.

    ``names`` maps prefill-cache keys to pool keys (e.g. ``k -> k_pages``).
    Tokens past the slot's allocation arrive mapped to the null page (the
    bucketed-prefill pad tail), whose content is garbage by design; their
    duplicate writes land in an undefined order on CUDA, which is harmless
    because page 0 is never read unmasked.
    """
    phys, off = phys_tok.long(), off_tok.long()
    for s_name, p_name in names.items():
        x = src[s_name][:, 0]  # (L, S, ...)
        pool = dst[p_name]
        pool[:, phys, off] = x.to(pool.dtype)
    return dst


# --------------------------------------------------------------------------
# The protocol
# --------------------------------------------------------------------------

class CacheAdapter:
    """One layer family's share of the engine cache.

    ``key`` is the segment-cache entry the adapter owns; ``param_key`` the
    layer-parameter subtree that drives it.  ``paged`` adapters draw on the
    shared physical page pool (page accounting in the allocator covers
    them); non-paged adapters own ``max_seqs`` per-slot rows.
    """

    key: str = ""
    param_key: str = ""
    family: str = ""  # human name the registry reports
    paged: bool = False
    # prefix sharing capability: a shareable adapter's cache entries are
    # position-indexed pages whose content is a pure function of the token
    # prefix, so physical pages may be aliased across requests.
    shareable: bool = False
    # True when the family's cache content depends on per-request inputs
    # beyond the token ids (enc-dec audio): token-keyed page aliasing is
    # then unsound for every co-resident adapter.
    side_inputs: bool = False
    # True when the adapter installs request-level context once at
    # admission (:meth:`admission_src`), outside the token-chunk loop.
    installs_at_admission: bool = False
    # True when the adapter's chunk resets the slot's rows on a request's
    # first chunk (it reads ``ctx["first"]``).
    first_chunk_resets: bool = False

    def copy_page(self, cfg: ModelConfig, seg_cache: Dict, src: int, dst: int) -> Dict:
        """Copy physical page ``src`` -> ``dst`` in this adapter's pools, in
        place (the COW step).  Only meaningful for paged adapters."""
        raise NotImplementedError

    def pool_pspecs(self, cfg: ModelConfig, *, tp_axis: str = "model",
                    tp_size: int = 1) -> Dict:
        """Spec per **L-stacked** pool leaf for tensor-parallel serving
        (``{pool_name: spec}``, each spec a tuple of per-dimension entries;
        missing names replicate).

        Specs describe the engine pools AFTER layer stacking (leading L
        axis, see :func:`repro_torch.models.model.init_paged_cache`).  Page
        ids, page tables and free lists are host state, computed alike on
        every rank, and never appear here.  The base adapter replicates
        everything; families whose pools carry a kv-head axis override to
        shard it over the model axis when it divides, so each rank holds
        (and streams) only its own heads' pages.
        """
        return {}

    def rank_cfg(self, cfg: ModelConfig, tp_size: int) -> ModelConfig:
        """``cfg`` as a rank's share of this adapter's caches is allocated
        with, on a model axis of ``tp_size`` ranks: its share of the kv
        heads where :meth:`pool_pspecs` shards them (the only axis a pool
        spec shards), else ``cfg``.  The one place the specs become
        shapes: the engine pools and the static caches both go through it."""
        specs = self.pool_pspecs(cfg, tp_size=tp_size)
        if any(e is not None for spec in specs.values() for e in spec):
            return dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // tp_size)
        return cfg

    def chunk_multiple(self, cfg: ModelConfig) -> int:
        """Prefill chunk boundaries must sit on multiples of this."""
        return 1

    def init_pool(self, cfg: ModelConfig, geom: CacheGeometry, device=None) -> Dict:
        """One layer's share of the engine cache (pre L-stacking): on a
        model axis of ``geom.tp_size`` ranks, this rank's share."""
        raise NotImplementedError

    def install(self, cfg: ModelConfig, dst: Dict, src: Dict, slot: int,
                phys_tok, off_tok) -> Dict:
        """Write one request's one-shot prefill cache into its slot, in place."""
        raise NotImplementedError

    def src_tokens(self, src: Dict) -> Optional[int]:
        """Token count of a (possibly padded) paged prefill source -- the
        host needs it to build per-token page targets.  None: not paged."""
        return None

    def chunk(self, p: Dict, cfg: ModelConfig, h, positions, cache: Dict,
              ctx: Dict, pos_offset: int):
        """One prompt chunk of one slot.  ``ctx`` carries {slot, table_row,
        phys_tok, off_tok}, and ``first`` where the config's adapters reset
        rows on a first chunk (:func:`first_chunk_resets`); the slot and
        ``first`` host values or 0-dim device tensors.  Returns
        (mixer_out, cache)."""
        raise NotImplementedError

    def decode(self, p: Dict, cfg: ModelConfig, h, positions, cache: Dict,
               *, seq_pos, page_table, active):
        """One lockstep decode step, every slot at its own position.
        Inactive slots' cache writes must be dropped (null page).  Returns
        (mixer_out, cache)."""
        raise NotImplementedError


class PagedAttnAdapter(CacheAdapter):
    """Full-attention dense/GQA: K/V paged in kernel-block-sized pages."""

    key = "attn"
    param_key = "attn"
    family = "dense/GQA (paged K/V)"
    paged = True
    shareable = True

    def init_pool(self, cfg, geom, device=None):
        return attn.paged_cache_init(self.rank_cfg(cfg, geom.tp_size), geom.num_pages,
                                     geom.page_size, device=device)

    def pool_pspecs(self, cfg, *, tp_axis="model", tp_size=1):
        # stacked pools are (L, num_pages, page, n_kv_heads, d_head): shard
        # the kv-head axis so each rank holds (and streams) 1/tp of every
        # page; pages themselves never cross ranks.  Query heads arrive
        # pre-partitioned by the column-parallel wq/wk/wv, so only the
        # post-attention row-parallel wo all-reduces.
        if tp_size > 1 and cfg.n_kv_heads % tp_size == 0:
            head = (None, None, None, tp_axis, None)
            return {"k_pages": head, "v_pages": head}
        return {}

    def copy_page(self, cfg, seg_cache, src, dst):
        return resolve_backend(cfg.decode_backend).paged_copy_page(seg_cache, src, dst)

    def install(self, cfg, dst, src, slot, phys_tok, off_tok):
        return _install_paged(dst, src, phys_tok, off_tok,
                              {"k": "k_pages", "v": "v_pages"})

    def src_tokens(self, src):
        return int(src["k"].shape[2])

    def chunk(self, p, cfg, h, positions, cache, ctx, pos_offset):
        return attn.gqa_paged_prefill_chunk(
            p, cfg, h, positions, cache, ctx["table_row"],
            ctx["phys_tok"], ctx["off_tok"], pos_offset,
        )

    def decode(self, p, cfg, h, positions, cache, *, seq_pos, page_table, active):
        return attn.gqa_paged_decode(
            p, cfg, h, positions, cache, page_table, seq_pos, active=active
        )


class RingAttnAdapter(CacheAdapter):
    """Sliding-window attention: O(window) ring row per batch slot.

    Not paged and not shareable: a ring is a slot-local summary of the
    sequence's last ``window`` tokens, so SWA configs serve unshared."""

    key = "attn"
    param_key = "attn"
    family = "SWA (ring)"
    first_chunk_resets = True

    def init_pool(self, cfg, geom, device=None):
        return attn.gqa_cache_init(self.rank_cfg(cfg, geom.tp_size), geom.max_seqs, geom.max_len,
                                   device=device, window_only=True)

    def pool_pspecs(self, cfg, *, tp_axis="model", tp_size=1):
        # stacked rings are (L, max_seqs, slots, n_kv_heads, d_head): the
        # head axis shards like the paged pools (ring attention is
        # head-independent); the position labels replicate.
        if tp_size > 1 and cfg.n_kv_heads % tp_size == 0:
            head = (None, None, None, tp_axis, None)
            return {"k": head, "v": head}
        return {}

    def install(self, cfg, dst, src, slot, phys_tok, off_tok):
        slots_e = dst["k"].shape[2]  # engine ring length: min(window, max_len)
        got = src["k"].shape[2]  # prefill ring length: min(window, S)
        assert got <= slots_e, (got, slots_e)
        # the token at absolute position p lives in ring slot p % slots_e; the
        # prefill packing already satisfies this for got == window (==
        # slots_e) and trivially for S < window (identity placement); the
        # rest of the row is blanked (position -1: masked)
        for name, empty in (("k", 0), ("v", 0), ("pos", -1)):
            row = dst[name][:, slot]
            row.fill_(empty)
            row[:, :got] = src[name][:, 0].to(row.dtype)
        return dst

    def chunk(self, p, cfg, h, positions, cache, ctx, pos_offset):
        # the first chunk resets the row's position labels to -1 (masked
        # empty) so a re-used slot cannot leak a previous occupant's window;
        # the chunk writes its tokens into the row, which goes back whole
        row = _first_chunk_reset(read_slot_rows(cache, ctx["slot"]), ctx["first"],
                                 {"pos": -1})
        out, row = attn.gqa_ring_prefill_chunk(p, cfg, h, positions, row, pos_offset,
                                               window=cfg.window)
        return out, write_slot_rows(cache, row, ctx["slot"])

    def decode(self, p, cfg, h, positions, cache, *, seq_pos, page_table, active):
        return attn.gqa_ring_decode(p, cfg, h, positions, cache, seq_pos,
                                    window=cfg.window, active=active)


class LatentMLAAdapter(CacheAdapter):
    """MLA (DeepSeek-V3): latent ``c_kv`` + shared rotary key paged.

    Pages hold ``kv_lora_rank + qk_rope_dim`` values per token instead of
    ``2 * n_kv_heads * d_head``.  Decode runs the absorbed-matmul
    formulation straight over the latent pages.
    """

    key = "attn"
    param_key = "attn"
    family = "MLA (latent pages)"
    paged = True
    shareable = True

    def init_pool(self, cfg, geom, device=None):
        return attn.mla_paged_cache_init(cfg, geom.num_pages, geom.page_size, device=device)

    def pool_pspecs(self, cfg, *, tp_axis="model", tp_size=1):
        # MLA latent pools carry NO head axis -- the rank-r c_kv and the
        # shared rotary key are read by every query head, so the pages
        # replicate (r + dr values per token against 2*Hkv*dh).  Head
        # parallelism lives on the activation side: the absorbed q_lat /
        # q_rope come from the column-parallel wq_b and each rank attends
        # its own heads against the whole latent pages.
        return {"ckv_pages": (), "krope_pages": ()}

    def copy_page(self, cfg, seg_cache, src, dst):
        return resolve_backend(cfg.decode_backend).paged_copy_page(seg_cache, src, dst)

    def install(self, cfg, dst, src, slot, phys_tok, off_tok):
        return _install_paged(dst, src, phys_tok, off_tok,
                              {"ckv": "ckv_pages", "krope": "krope_pages"})

    def src_tokens(self, src):
        return int(src["ckv"].shape[2])

    def chunk(self, p, cfg, h, positions, cache, ctx, pos_offset):
        return attn.mla_paged_prefill_chunk(
            p, cfg, h, positions, cache, ctx["table_row"],
            ctx["phys_tok"], ctx["off_tok"], pos_offset,
        )

    def decode(self, p, cfg, h, positions, cache, *, seq_pos, page_table, active):
        return attn.mla_paged_decode(
            p, cfg, h, positions, cache, page_table, seq_pos, active=active
        )


class SSMStateAdapter(CacheAdapter):
    """SSM (mamba2, the hybrid's SSM branch): O(1) state + conv rows per slot.

    Not paged and not shareable: the rows are a slot-local summary of the
    whole sequence."""

    key = "ssm"
    param_key = "ssm"
    family = "SSM (state rows)"
    first_chunk_resets = True

    def chunk_multiple(self, cfg):
        # chunk boundaries sit on the SSD chunk grid -- the grid the one-shot
        # prefill uses -- so every chunk runs the one-shot path's exact
        # per-chunk ops (bit-exactness)
        return cfg.ssm_chunk

    def init_pool(self, cfg, geom, device=None):
        return ssmm.ssm_state_init(cfg, geom.max_seqs, device=device)

    def install(self, cfg, dst, src, slot, phys_tok, off_tok):
        return write_slot_rows(dst, src, slot, axis=1)

    def chunk(self, p, cfg, h, positions, cache, ctx, pos_offset):
        # the first chunk zeroes the row (it may hold a previous occupant's
        # state): zero state and history are exactly the one-shot prefill's
        row = read_slot_rows(cache, ctx["slot"])
        row = _first_chunk_reset(row, ctx["first"], {k: 0 for k in row})
        out, st = ssmm.ssm_forward(p, cfg, h, mode="prefill", state=row)
        return out, write_slot_rows(cache, st, ctx["slot"])

    def decode(self, p, cfg, h, positions, cache, *, seq_pos, page_table, active):
        out, st = ssmm.ssm_step(p, cfg, h, cache)
        for name, new in st.items():
            old = cache[name]
            new = new.to(old.dtype)
            if active is not None:  # an inactive slot keeps its rows bit for bit
                new = torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
            old.copy_(new)
        return out, cache


class CrossAttnAdapter(CacheAdapter):
    """Encoder-decoder cross-attention: immutable encoder-side K/V rows.

    The encoder runs ONCE per request at admission; its projected K/V are
    installed into the slot's rows and never written again -- chunked
    decoder prefill and decode both read the same rows, so preemption with
    recompute only re-runs the encoder.
    """

    key = "cross"
    param_key = "cross"
    family = "enc-dec (cross rows + paged self-attn)"
    installs_at_admission = True
    side_inputs = True  # the rows depend on the request's audio

    def init_pool(self, cfg, geom, device=None):
        hkv = self.rank_cfg(cfg, geom.tp_size).n_kv_heads
        shape = (geom.max_seqs, cfg.encoder_seq, hkv, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    def pool_pspecs(self, cfg, *, tp_axis="model", tp_size=1):
        # stacked cross rows are (L, max_seqs, encoder_seq, n_kv_heads,
        # d_head): immutable per request, head-sharded like the paged pools
        # so cross-attention reads stay local to each rank's heads.
        if tp_size > 1 and cfg.n_kv_heads % tp_size == 0:
            head = (None, None, None, tp_axis, None)
            return {"k": head, "v": head}
        return {}

    def install(self, cfg, dst, src, slot, phys_tok, off_tok):
        return write_slot_rows(dst, src, slot, axis=1)

    def admission_src(self, cfg, params, batch: Dict) -> Dict:
        """Encoder-side K/V of one request as a partial install source, the
        stacked per-layer rows split along the segment boundaries."""
        from repro_torch.models import model as M

        kv = M.encdec_cross_kv(cfg, params, batch["audio_embeds"])
        src, off = {}, 0
        for si, (kind, n) in enumerate(layer_segments(cfg)):
            if self in adapters_for(cfg, kind):
                src[f"seg{si}"] = {"cross": {k: v[off:off + n] for k, v in kv.items()}}
            off += n
        return src

    def chunk(self, p, cfg, h, positions, cache, ctx, pos_offset):
        rows = read_slot_rows(cache, ctx["slot"])
        return attn.cross_attention(p, cfg, h, rows["k"], rows["v"]), cache

    def decode(self, p, cfg, h, positions, cache, *, seq_pos, page_table, active):
        # read only: inactive slots' outputs are discarded, nothing to mask
        return attn.cross_attention(p, cfg, h, cache["k"], cache["v"]), cache


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

PAGED_GQA = PagedAttnAdapter()
RING_SWA = RingAttnAdapter()
MLA_LATENT = LatentMLAAdapter()
SSM_STATE = SSMStateAdapter()
CROSS_ENC = CrossAttnAdapter()

_ATTN_ADAPTERS = {"full": PAGED_GQA, "swa": RING_SWA, "mla": MLA_LATENT}


def static_cache_cfgs(cfg: ModelConfig, tp_size: int) -> Tuple[ModelConfig, ModelConfig]:
    """The configs a rank's static (``Server``) caches are allocated with:
    ``(self-attention and SSM rows, cross-attention rows)``.  The static
    K/V share the engine pools' head axis, so the attention family's and
    the cross rows' adapters place them (:meth:`CacheAdapter.rank_cfg`);
    the vision frontend, which has no engine, places its GQA caches as the
    paged pools would."""
    return (_ATTN_ADAPTERS[cfg.attn_type].rank_cfg(cfg, tp_size),
            CROSS_ENC.rank_cfg(cfg, tp_size))


def adapters_for(cfg: ModelConfig, kind: str) -> List[CacheAdapter]:
    """Adapters serving one segment kind, in mixer order (attention first:
    the hybrid fusion averages outputs in this order; the cross rows after
    the self mixer).  Raises for a family whose adapter is not ported yet."""
    msg = unsupported_message(cfg)
    if msg is not None:
        raise NotImplementedError(msg)
    ads: List[CacheAdapter] = []
    if kind in ("dense", "moe", "hybrid"):
        ads.append(_ATTN_ADAPTERS[cfg.attn_type])
        if cfg.n_encoder_layers:
            ads.append(CROSS_ENC)
    if kind in ("ssm", "hybrid"):
        ads.append(SSM_STATE)
    if not ads:
        raise NotImplementedError(f"{cfg.name}: no cache adapter for segment kind {kind!r}")
    return ads


def all_adapters(cfg: ModelConfig) -> List[CacheAdapter]:
    """Every adapter the config's segments use (deduplicated, in order)."""
    seen: List[CacheAdapter] = []
    for kind, _n in layer_segments(cfg):
        for ad in adapters_for(cfg, kind):
            if ad not in seen:
                seen.append(ad)
    return seen


def admission_adapters(cfg: ModelConfig) -> List[CacheAdapter]:
    """Adapters that install request-level context once at admission,
    outside the token-chunk loop (enc-dec encoder K/V)."""
    return [ad for ad in all_adapters(cfg) if ad.installs_at_admission]


def prefix_shareable(cfg: ModelConfig) -> bool:
    """Whether this config's physical pages may be ALIASED across requests
    with a matching token prefix (memory dedup + COW on divergence):
    at least one shareable paged adapter and no side-input family."""
    ads = all_adapters(cfg)
    return (any(ad.shareable for ad in ads)
            and not any(ad.side_inputs for ad in ads))


def prefix_compute_skippable(cfg: ModelConfig) -> bool:
    """Whether a cached prefix lets admission SKIP the prefix's prefill
    chunks entirely (start chunking at the first uncached page boundary):
    every adapter shareable and no MoE segment."""
    if not prefix_shareable(cfg):
        return False
    if any(kind == "moe" for kind, _n in layer_segments(cfg)):
        return False
    return all(ad.shareable for ad in all_adapters(cfg))


def first_chunk_resets(cfg: ModelConfig) -> bool:
    """Whether some adapter of the config resets its slot rows on a
    request's first chunk (the chunk context then carries ``first``)."""
    return any(ad.first_chunk_resets for ad in all_adapters(cfg))


def prefill_chunk_multiple(cfg: ModelConfig) -> int:
    """Grid every prefill chunk boundary must sit on (lcm over adapters)."""
    m = 1
    for ad in all_adapters(cfg):
        m = math.lcm(m, ad.chunk_multiple(cfg))
    return m


def supported_families() -> Tuple[str, ...]:
    """Family names the adapter registry serves (the engine error text and
    the launch driver report exactly this list)."""
    return (PAGED_GQA.family, RING_SWA.family, MLA_LATENT.family, SSM_STATE.family,
            CROSS_ENC.family)


def unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the continuous-batching engine cannot serve this config (None =
    it can): the vision frontend's M-RoPE prefix, as in the JAX package."""
    if cfg.frontend == "vision" or cfg.mrope_sections:
        return ("the vision frontend (M-RoPE position streams + image prefix) "
                "has no cache adapter yet")
    if cfg.attn_type not in _ATTN_ADAPTERS or cfg.family not in (
            "dense", "moe", "ssm", "hybrid", "encdec"):
        return f"family {cfg.family!r} / attention {cfg.attn_type!r} has no adapter"
    return None


def unsupported_message(cfg: ModelConfig, hint: str = "") -> Optional[str]:
    """The ONE unsupported-family error text (None = config is served):
    the reason plus exactly the families the registry reports."""
    reason = unsupported_reason(cfg)
    if reason is None:
        return None
    msg = (f"{cfg.name}: {reason}; the paged engine serves: "
           + ", ".join(supported_families()))
    return msg + (f" -- {hint}" if hint else "")
