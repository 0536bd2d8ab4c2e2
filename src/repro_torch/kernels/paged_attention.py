"""Paged one-token GQA decode and the COW page copy: the CUDA kernels
``csrc/paged_attention.cu`` and their plain versions.

Counterpart of ``repro.kernels.paged_attention`` (its MLA kernel waits for
the MLA slice, ROADMAP.md queue 2 item 8).  The serving engine sizes its
KV-cache pages to the kernel block so that the decode step can read them in
place: :func:`paged_attention_decode` walks each slot's page-table row page
by page with an online softmax, so the gathered history never exists in
device memory, and :func:`paged_copy` is the copy-on-write step of
shared-prefix serving, one page in every layer of a stacked pool, in place.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version for CPU tensors; ``launches`` counts the kernel launches only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.blockwise import no_tf32
from repro_torch.kernels import _build

# the reference path's mask fill, and the online softmax's initial running
# max: a fully masked key then adds exp(MASK - m) == 0 exactly
MASK = torch.finfo(torch.float32).min
DECODE_DTYPES = (torch.float32, torch.bfloat16)


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
    tensors launch ``csrc/paged_attention.cu``; CPU tensors take
    :func:`decode_plain`.
    """
    tensors = (q, k_pages, v_pages, page_table, seq_pos)
    if not _build.on_cuda("paged_attention_decode", *tensors):
        return decode_plain(q, k_pages, v_pages, page_table, seq_pos, scale=scale)
    B, H, hkv, dh, page, maxp = _check_decode(*tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_decode: operand of shape {tuple(t.shape)} "
                             "is not contiguous")
    scale = dh ** -0.5 if scale is None else scale
    lib = _build.library()
    out = torch.empty_like(q)
    entry = (lib.paged_attention_decode_f32 if q.dtype == torch.float32
             else lib.paged_attention_decode_bf16)
    with torch.cuda.device(q.device):
        # scalar loads only: no alignment beyond the element's own
        ptrs = [t.data_ptr() for t in (*tensors, out)]
        code = entry(*ptrs, B, H, hkv, dh, page, maxp, float(scale),
                     _build.stream(q.device))
    _build.check(code, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


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
    ``csrc/paged_attention.cu``; CPU tensors take :func:`copy_plain`."""
    if not _build.on_cuda("paged_copy", pool):
        return copy_plain(pool, src, dst)
    _check_copy(pool, src, dst)
    if not pool.is_contiguous():
        raise ValueError(f"paged_copy: pool of shape {tuple(pool.shape)} is not contiguous")
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
