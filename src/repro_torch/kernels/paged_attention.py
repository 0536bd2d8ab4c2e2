"""Paged one-token GQA and MLA decode and the COW page copy: the CUDA
kernels ``csrc/paged_attention.cu`` and their plain versions.

Counterpart of ``repro.kernels.paged_attention``.  The serving engine sizes
its KV-cache pages to the kernel block so that the decode step can read
them in place: :func:`paged_attention_decode` (K/V pages) and
:func:`mla_paged_attention_decode` (MLA's latent pages, absorbed
formulation) read each key through the slot's page-table row with an online
softmax, so the gathered history never exists in device memory; their
kernels split each slot's history into fixed runs of :data:`SPLIT_KEYS` /
:data:`MLA_SPLIT_KEYS` keys and merge the runs' partial softmaxes.
:func:`paged_copy` is the copy-on-write step of shared-prefix serving, one
page in every layer of a stacked pool, in place.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version for CPU tensors; ``launches`` counts the kernel launches only.  The
decodes take any view (copied first, :func:`_build.operands`); the page copy,
which writes in place, takes a contiguous pool only.
"""
from __future__ import annotations

import contextlib
import struct
from typing import Optional, Tuple

import torch

from repro_torch.core.blockwise import no_tf32
from repro_torch.kernels import _build

# the reference path's mask fill, and the online softmax's initial running
# max: a fully masked key then adds exp(MASK - m) == 0 exactly
MASK = torch.finfo(torch.float32).min
DECODE_DTYPES = (torch.float32, torch.bfloat16)
# The GQA decode kernel's partition of a slot's history (kSplitKeys in
# csrc/paged_attention.cu): a CTA owns SPLIT_KEYS keys of one slot, fixed in
# keys -- not derived from B, maxp or the card -- so that a slot's output
# does not depend on the other slots.  Its grid's split dimension, and the
# kernel's head width (64 kMaxDimChunks), have these limits.
SPLIT_KEYS = 128
MAX_SPLITS = 65535
MAX_HEAD_DIM = 256
# The MLA decode kernel's partition (MlaMath<T>::kSplitKeys), fixed in keys
# for the same reason, for each pool type: fp32 pools run one CTA a SM, so
# larger splits fill the card in one round; bf16 pools run two.  Its widths:
# a warp holds the query fragments of r + dr dims (kMlaMaxDims) and the
# output columns of r (kMlaMaxLatent, 64 a warp).
MLA_SPLIT_KEYS = {torch.float32: 256, torch.bfloat16: 128}
MLA_MAX_LATENT = 512
MLA_MAX_DIMS = 576


def decode_plan(page: int, maxp: int) -> Tuple[int, int]:
    """``(split_keys, splits)`` of the GQA decode kernel for a table of
    ``maxp`` pages of ``page`` keys: split ``z`` owns the keys ``[z *
    split_keys, (z + 1) * split_keys)`` of every slot, and ``splits`` of them
    cover the table's reach.  Raises past the grid's 65535."""
    splits = -(-(page * maxp) // SPLIT_KEYS)
    if splits > MAX_SPLITS:
        raise ValueError(f"paged_attention_decode: {maxp} pages of {page} keys need "
                         f"{splits} splits of {SPLIT_KEYS}, over the grid's {MAX_SPLITS}")
    return SPLIT_KEYS, splits


def mla_decode_plan(page: int, maxp: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(split_keys, splits)`` of the MLA decode kernel for pools of
    ``dtype``, as :func:`decode_plan` with :data:`MLA_SPLIT_KEYS`."""
    split_keys = MLA_SPLIT_KEYS[dtype]
    splits = -(-(page * maxp) // split_keys)
    if splits > MAX_SPLITS:
        raise ValueError(f"mla_paged_attention_decode: {maxp} pages of {page} keys need "
                         f"{splits} splits of {split_keys}, over the grid's {MAX_SPLITS}")
    return split_keys, splits


def mla_workspace_floats(B: int, H: int, splits: int, r: int, dtype: torch.dtype) -> int:
    """The fp32 words of the MLA split kernel's partials: ``l (B, H,
    splits)`` in the accumulation type (fp64 for fp32 pools, two words each;
    fp32 for bf16 pools), then ``m (B, H, splits)`` and ``acc (B, H, splits,
    r)`` in fp32."""
    words = 2 if dtype == torch.float32 else 1
    return B * H * splits * (words + 1 + r)


# the split kernel's partials, one buffer per (device, stream), grown as
# needed: launches on one stream run in order, so each call may reuse it,
# and the serving step, host-bound, saves an allocation per layer
_workspaces = {}


@contextlib.contextmanager
def own_workspaces(store: dict):
    """Take the split kernels' partials from ``store`` inside the scope, not
    from the shared cache.  A CUDA graph replays the pointer it captured:
    the graph's owner keeps its own buffers in ``store``, so no later call
    on the same stream can grow the shared buffer and free the captured
    one."""
    global _workspaces
    shared, _workspaces = _workspaces, store
    try:
        yield store
    finally:
        _workspaces = shared


def _workspace(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < numel:
        ws = _workspaces[key] = torch.empty(numel, dtype=torch.float32, device=device)
    return ws


def _check_decode(q, k_pages, v_pages, page_table, seq_pos):
    """Check the operands on either device; return (B, H, hkv, dh, page, maxp)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_attention_decode: q must be (B, 1, H, dh), "
                         f"got {tuple(q.shape)}")
    B, _, H, dh = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_attention_decode: pools must both be (num_pages, page, "
                         f"Hkv, dh), got {tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    _, page, hkv, dh_k = k_pages.shape
    if dh_k != dh or H % hkv:
        raise ValueError(f"paged_attention_decode: q {tuple(q.shape)} does not fit "
                         f"pools {tuple(k_pages.shape)}")
    if q.dtype not in DECODE_DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention_decode: q and pools must share one of "
                        f"{DECODE_DTYPES}, got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if page_table.dim() != 2 or page_table.shape[0] != B or tuple(seq_pos.shape) != (B,):
        raise ValueError(f"paged_attention_decode: page_table must be (B, maxp) and "
                         f"seq_pos (B,) with B={B}, got {tuple(page_table.shape)}, "
                         f"{tuple(seq_pos.shape)}")
    if page_table.dtype != torch.int32 or seq_pos.dtype != torch.int32:
        raise TypeError("paged_attention_decode: page_table and seq_pos must be int32")
    return B, H, hkv, dh, page, page_table.shape[1]


@no_tf32()
def decode_plain(q, k_pages, v_pages, page_table, seq_pos, *,
                 scale: Optional[float] = None):
    """Plain PyTorch version of the kernel, in the TPU kernel's order: walk
    every page of each slot's table row, mask keys past ``seq_pos``
    (inclusive bound) with :data:`MASK`, and carry an fp32 online softmax
    across the pages.  Query heads fold onto their kv head.  Returns
    ``(B, 1, H, dh)`` in ``q.dtype``."""
    B, H, hkv, dh, page, maxp = _check_decode(q, k_pages, v_pages, page_table, seq_pos)
    g = H // hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q[:, 0].float().reshape(B, hkv, g, dh)
    acc = torch.zeros(B, hkv, g, dh, dtype=torch.float32, device=q.device)
    m = torch.full((B, hkv, g, 1), MASK, dtype=torch.float32, device=q.device)
    den = torch.zeros(B, hkv, g, 1, dtype=torch.float32, device=q.device)
    table = page_table.long()
    pos = seq_pos.long()[:, None]
    offs = torch.arange(page, device=q.device)
    for j in range(maxp):
        k = k_pages[table[:, j]].float()  # (B, page, hkv, dh)
        v = v_pages[table[:, j]].float()
        s = torch.einsum("bhgd,bphd->bhgp", qg, k) * scale
        valid = (j * page + offs)[None, :] <= pos  # (B, page)
        s = torch.where(valid[:, None, None, :], s, MASK)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgp,bphd->bhgd", p, v)
        m = m_new
    den = torch.where(den == 0.0, 1.0, den)  # unreachable: position 0 is valid
    return (acc / den).reshape(B, 1, H, dh).to(q.dtype)


def paged_attention_decode(q, k_pages, v_pages, page_table, seq_pos, *,
                           scale: Optional[float] = None):
    """Fused one-token GQA decode over the block-paged K/V pool.

    ``q``: (B, 1, H, dh); ``k_pages``/``v_pages``: (num_pages, page, Hkv,
    dh), fp32 or bf16 like ``q``; ``page_table``: (B, max_pages) int32;
    ``seq_pos``: (B,) int32, each >= 0.  Returns (B, 1, H, dh) in
    ``q.dtype``: the contract of the reference gather + attend read.  CUDA
    tensors launch ``csrc/paged_attention.cu`` (dh up to 256): the split
    kernel over :func:`decode_plan`'s grid, then the combine, one launch in
    ``launches``; CPU tensors take :func:`decode_plain`.
    """
    tensors = (q, k_pages, v_pages, page_table, seq_pos)
    if not _build.on_cuda("paged_attention_decode", *tensors):
        return decode_plain(q, k_pages, v_pages, page_table, seq_pos, scale=scale)
    B, H, hkv, dh, page, maxp = _check_decode(*tensors)
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention_decode: the kernel takes dh up to "
                         f"{MAX_HEAD_DIM}, got {dh}")
    _, splits = decode_plan(page, maxp)
    # a view is copied; an unaligned pool is not: the kernel narrows its words
    tensors = _build.operands(*tensors)
    scale = dh ** -0.5 if scale is None else scale
    lib = _build.library()
    out = torch.empty_like(tensors[0])
    entry = (lib.paged_attention_decode_f32 if q.dtype == torch.float32
             else lib.paged_attention_decode_bf16)
    with torch.cuda.device(q.device):
        stream = _build.stream(q.device)
        # each split's partial: acc (B, H, splits, dh), then (max, denominator)
        ws = _workspace(q.device, stream, B * H * splits * (dh + 2))
        # the kernel copies K/V rows in the widest words (16, 8, 4 or 2
        # bytes) that dh and the pools' addresses allow
        ptrs = [t.data_ptr() for t in (*tensors, out, ws)]
        code = entry(*ptrs, B, H, hkv, dh, page, maxp, splits, float(scale), stream)
    _build.check(code, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def _check_mla(q_lat, q_rope, ckv_pages, krope_pages, page_table, seq_pos):
    """Check the MLA operands on either device; return (B, H, r, dr, page, maxp)."""
    if q_lat.dim() != 4 or q_lat.shape[1] != 1 or q_rope.dim() != 4 or \
            q_rope.shape[:3] != q_lat.shape[:3]:
        raise ValueError("mla_paged_attention_decode: q_lat must be (B, 1, H, r) and "
                         f"q_rope (B, 1, H, dr), got {tuple(q_lat.shape)} and "
                         f"{tuple(q_rope.shape)}")
    B, _, H, r = q_lat.shape
    dr = q_rope.shape[-1]
    if ckv_pages.dim() != 3 or krope_pages.dim() != 3 or \
            ckv_pages.shape[:2] != krope_pages.shape[:2] or ckv_pages.shape[2] != r or \
            krope_pages.shape[2] != dr:
        raise ValueError("mla_paged_attention_decode: pools must be (num_pages, page, r) "
                         f"and (num_pages, page, dr) for r={r}, dr={dr}, got "
                         f"{tuple(ckv_pages.shape)} and {tuple(krope_pages.shape)}")
    dtypes = {t.dtype for t in (q_lat, q_rope, ckv_pages, krope_pages)}
    if len(dtypes) != 1 or ckv_pages.dtype not in DECODE_DTYPES:
        raise TypeError("mla_paged_attention_decode: queries and pools must share one of "
                        f"{DECODE_DTYPES}, got {sorted(map(str, dtypes))}")
    if page_table.dim() != 2 or page_table.shape[0] != B or tuple(seq_pos.shape) != (B,):
        raise ValueError(f"mla_paged_attention_decode: page_table must be (B, maxp) and "
                         f"seq_pos (B,) with B={B}, got {tuple(page_table.shape)}, "
                         f"{tuple(seq_pos.shape)}")
    if page_table.dtype != torch.int32 or seq_pos.dtype != torch.int32:
        raise TypeError("mla_paged_attention_decode: page_table and seq_pos must be int32")
    return B, H, r, dr, ckv_pages.shape[1], page_table.shape[1]


@no_tf32()
def mla_decode_plain(q_lat, q_rope, ckv_pages, krope_pages, page_table, seq_pos, *,
                     scale: float):
    """Plain PyTorch version of the MLA kernel, in the TPU kernel's order:
    walk every page of each slot's table row, score ``scale * (q_lat . c_kv +
    q_rope . k_rope)``, mask keys past ``seq_pos`` (inclusive bound) with
    :data:`MASK`, carry an online softmax across the pages and keep the
    probabilities for the ``p @ c_kv`` product (the gather oracle casts them
    to the pools' type first).  Scores, running max, probabilities and
    rescale factors are fp32 values, as in the TPU kernel; the dot products
    and the sums over keys accumulate in fp64 for fp32 pools (fp32 for bf16
    pools) and round once, as the CUDA kernel does, so that the two agree to
    an ulp whatever order each sums in.  Returns ``(B, 1, H, r)`` in the
    pools' type."""
    B, H, r, dr, page, maxp = _check_mla(q_lat, q_rope, ckv_pages, krope_pages,
                                         page_table, seq_pos)
    acc_t = torch.float64 if ckv_pages.dtype == torch.float32 else torch.float32
    # the kernel's fp32 scale, rounded on the host (no tensor, no sync)
    scale = struct.unpack("f", struct.pack("f", scale))[0]
    ql = q_lat[:, 0].to(acc_t)  # (B, H, r)
    qr = q_rope[:, 0].to(acc_t)
    acc = torch.zeros(B, H, r, dtype=acc_t, device=ql.device)
    m = torch.full((B, H, 1), MASK, dtype=torch.float32, device=ql.device)
    den = torch.zeros(B, H, 1, dtype=acc_t, device=ql.device)
    table = page_table.long()
    pos = seq_pos.long()[:, None]
    offs = torch.arange(page, device=ql.device)
    for j in range(maxp):
        c = ckv_pages[table[:, j]].to(acc_t)  # (B, page, r)
        kr = krope_pages[table[:, j]].to(acc_t)  # (B, page, dr)
        s = torch.einsum("bhr,bpr->bhp", ql, c) + torch.einsum("bhd,bpd->bhp", qr, kr)
        s = (s * scale).float()
        valid = (j * page + offs)[None, :] <= pos  # (B, page)
        s = torch.where(valid[:, None, :], s, MASK)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        den = den * alpha.to(acc_t) + p.to(acc_t).sum(-1, keepdim=True)
        acc = acc * alpha.to(acc_t) + torch.einsum("bhp,bpr->bhr", p.to(acc_t), c)
        m = m_new
    den = torch.where(den == 0.0, 1.0, den)  # unreachable: position 0 is valid
    return (acc / den).float()[:, None].to(ckv_pages.dtype)


def mla_paged_attention_decode(q_lat, q_rope, ckv_pages, krope_pages, page_table, seq_pos,
                               *, scale: float):
    """Fused one-token MLA decode over the block-paged *latent* pool.

    ``q_lat``: (B, 1, H, r) -- q_nope already absorbed through ``W_kv_b``;
    ``q_rope``: (B, 1, H, dr); ``ckv_pages``: (num_pages, page, r);
    ``krope_pages``: (num_pages, page, dr); all four fp32 or all bf16;
    ``page_table``: (B, max_pages) int32; ``seq_pos``: (B,) int32, each >= 0.
    Returns the latent-space output ``o_lat`` (B, 1, H, r) in the pools'
    type -- the caller applies the value expansion.  CUDA tensors launch
    ``csrc/paged_attention.cu`` (r up to 512, r + dr up to 576): the split
    kernel over :func:`mla_decode_plan`'s grid, then the combine, one launch
    in ``launches``; CPU tensors take :func:`mla_decode_plain`.
    """
    tensors = (q_lat, q_rope, ckv_pages, krope_pages, page_table, seq_pos)
    if not _build.on_cuda("mla_paged_attention_decode", *tensors):
        return mla_decode_plain(*tensors, scale=scale)
    B, H, r, dr, page, maxp = _check_mla(*tensors)
    if r > MLA_MAX_LATENT or r + dr > MLA_MAX_DIMS:
        raise ValueError(f"mla_paged_attention_decode: the kernel takes r up to "
                         f"{MLA_MAX_LATENT} and r + dr up to {MLA_MAX_DIMS}, got r={r}, "
                         f"dr={dr}")
    _, splits = mla_decode_plan(page, maxp, q_lat.dtype)
    # a view is copied; an unaligned pool is not: the kernel narrows its words
    tensors = _build.operands(*tensors)
    lib = _build.library()
    out = torch.empty_like(tensors[0])
    entry = (lib.mla_paged_attention_decode_f32 if q_lat.dtype == torch.float32
             else lib.mla_paged_attention_decode_bf16)
    with torch.cuda.device(q_lat.device):
        stream = _build.stream(q_lat.device)
        ws = _workspace(q_lat.device, stream, mla_workspace_floats(B, H, splits, r, q_lat.dtype))
        # the kernel copies latent and rope rows in the widest words (16, 8,
        # 4 or 2 bytes) that r, dr and the pools' addresses allow
        ptrs = [t.data_ptr() for t in (*tensors, out, ws)]
        code = entry(*ptrs, B, H, r, dr, page, maxp, splits, float(scale), stream)
    _build.check(code, "mla_paged_attention_decode")
    mla_paged_attention_decode.launches += 1
    return out


mla_paged_attention_decode.launches = 0


def _check_copy(pool, src, dst):
    if pool.dim() < 3:
        raise ValueError(f"paged_copy: pool must be (L, num_pages, page, ...), "
                         f"got {tuple(pool.shape)}")
    for name, page in (("src", src), ("dst", dst)):
        if not isinstance(page, int):
            raise TypeError(f"paged_copy: {name} must be a host int page id, "
                            f"got {type(page).__name__}")
        if not 0 <= page < pool.shape[1]:
            raise ValueError(f"paged_copy: {name} page {page} outside "
                             f"[0, {pool.shape[1]})")


def copy_plain(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Plain PyTorch version: ``pool[:, dst] = pool[:, src]`` in place."""
    _check_copy(pool, src, dst)
    if src != dst:
        pool[:, dst].copy_(pool[:, src])
    return pool


def paged_copy(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy physical page ``src`` -> ``dst`` in every layer of one stacked
    page pool ``(L, num_pages, page, ...)``, in place, bit-exact, for any
    element type; returns ``pool`` itself (the JAX kernel aliases its output
    to the pool for the same effect).  CUDA tensors launch
    ``csrc/paged_attention.cu``; CPU tensors take :func:`copy_plain`.

    Unlike the other wrappers it refuses a view that is not contiguous
    rather than copying it: the copy is written in place, and a contiguous
    copy of the pool would take the write instead of the caller's pool.  An
    unaligned pool is taken as it is, in narrower words."""
    if not _build.on_cuda("paged_copy", pool):
        return copy_plain(pool, src, dst)
    _check_copy(pool, src, dst)
    if not pool.is_contiguous():
        raise ValueError(f"paged_copy: pool of shape {tuple(pool.shape)} is not contiguous; "
                         "the copy is made in place, so a contiguous copy of the pool would "
                         "take it instead")
    layers = pool.shape[0]
    page_bytes = pool[0, 0].numel() * pool.element_size()
    layer_bytes = pool.shape[1] * page_bytes
    with torch.cuda.device(pool.device):
        code = _build.library().paged_copy(pool.data_ptr(), layers, layer_bytes, page_bytes,
                                           src, dst, _build.stream(pool.device))
    _build.check(code, "paged_copy")
    paged_copy.launches += 1
    return pool


paged_copy.launches = 0
