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

This port serves full-attention dense/GQA layers (:class:`PagedAttnAdapter`,
K/V paged).  The other families' adapters wait for their slices, and
:func:`unsupported_message` refuses them naming the ROADMAP.md item that
ports each: the SWA ring, MLA latent pages, SSM state rows, enc-dec cross
rows, MoE, and the vision frontend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_backend
from repro_torch.models import attention as attn


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


# --------------------------------------------------------------------------
# Shared slot-row helpers (per-slot, non-paged layouts)
# --------------------------------------------------------------------------

def read_slot_rows(seg_cache: Dict, slot: int) -> Dict:
    """One batch slot's rows as a (1, ...) dict of views."""
    return {k: v[slot:slot + 1] for k, v in seg_cache.items()}


def write_slot_rows(seg_cache: Dict, rows: Dict, slot: int, *, axis: int = 0) -> Dict:
    """Write one slot's rows into the per-slot cache tensors, in place.

    ``axis`` is the slot axis: 0 inside a layer step, 1 for install into the
    full (L, max_seqs, ...) pools.
    """
    index = (slice(None),) * axis + (slice(slot, slot + 1),)
    for k in seg_cache:
        seg_cache[k][index] = rows[k].to(seg_cache[k].dtype)
    return seg_cache


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

    def copy_page(self, cfg: ModelConfig, seg_cache: Dict, src: int, dst: int) -> Dict:
        """Copy physical page ``src`` -> ``dst`` in this adapter's pools, in
        place (the COW step).  Only meaningful for paged adapters."""
        raise NotImplementedError

    def chunk_multiple(self, cfg: ModelConfig) -> int:
        """Prefill chunk boundaries must sit on multiples of this."""
        return 1

    def init_pool(self, cfg: ModelConfig, geom: CacheGeometry, device=None) -> Dict:
        """One layer's share of the engine cache (pre L-stacking)."""
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
        """One prompt chunk of one slot.  ``ctx`` carries {slot, first,
        table_row, phys_tok, off_tok}.  Returns (mixer_out, cache)."""
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
        return attn.paged_cache_init(cfg, geom.num_pages, geom.page_size, device=device)

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


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

PAGED_GQA = PagedAttnAdapter()


def adapters_for(cfg: ModelConfig, kind: str) -> List[CacheAdapter]:
    """Adapters serving one segment kind, in mixer order.  Raises for a
    family whose adapter is not ported yet."""
    msg = unsupported_message(cfg)
    if msg is not None:
        raise NotImplementedError(msg)
    if kind != "dense":
        raise NotImplementedError(f"{cfg.name}: no cache adapter for segment kind {kind!r}")
    return [PAGED_GQA]


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
    outside the token-chunk loop (enc-dec encoder K/V in the JAX package;
    none of the ported families)."""
    return [
        ad for ad in all_adapters(cfg)
        if getattr(ad, "installs_at_admission", False)
    ]


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


def prefill_chunk_multiple(cfg: ModelConfig) -> int:
    """Grid every prefill chunk boundary must sit on (lcm over adapters)."""
    m = 1
    for ad in all_adapters(cfg):
        m = math.lcm(m, ad.chunk_multiple(cfg))
    return m


def supported_families() -> Tuple[str, ...]:
    """Family names the adapter registry serves (the engine error text and
    the launch driver report exactly this list)."""
    return (PAGED_GQA.family,)


def unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the port cannot serve this config yet, naming the ROADMAP.md item
    that ports it (None = it can)."""
    if cfg.frontend == "vision" or cfg.mrope_sections:
        return ("the vision frontend (M-RoPE position streams + image prefix) "
                "is not ported yet (ROADMAP.md queue 1 item 24)")
    if cfg.n_encoder_layers:
        return ("enc-dec cross-attention rows are not ported yet "
                "(ROADMAP.md queue 1 item 22)")
    if cfg.family in ("ssm", "hybrid"):
        return ("SSM state rows are not ported yet (ROADMAP.md queue 1 item 21)")
    if cfg.family == "moe" or cfg.n_experts:
        return "MoE layers are not ported yet (ROADMAP.md queue 1 item 19)"
    if cfg.attn_type == "mla":
        return ("MLA latent pages are not ported yet "
                "(ROADMAP.md queue 1 item 18, queue 2 item 8)")
    if cfg.attn_type == "swa":
        return ("the sliding-window ring cache is not ported yet "
                "(ROADMAP.md queue 1 item 20)")
    if cfg.attn_type != "full" or cfg.family != "dense":
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
