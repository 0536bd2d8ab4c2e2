"""Fused blocked attention, scores -> softmax -> @V: ``csrc/bwma_attention.cu``
and its plain version.

Counterpart of ``repro.kernels.bwma_attention``.  The ``(S, S)`` score
matrix never exists in device memory.  Unlike the TPU kernel, which holds
all of K and V on chip for one query block-row, the CUDA kernel streams K
and V one key block at a time with an online softmax, because all of K and
V at BERT-base does not fit in one CTA's shared memory.  The plain version
walks the key blocks with the same online softmax, so the CPU tests already
hold the streaming math against the JAX kernel's single pass.

Padding semantics match the reference operators: padded *key* positions get
probability exactly 0; padded *d_head* columns stay 0; padded query rows are
finite garbage that is cropped at unblock time.
"""
from __future__ import annotations

import torch

from repro_torch.core.blockwise import Blocked, no_tf32
from repro_torch.kernels import _build
from repro_torch.kernels.batching import lead_grid

# query rows per CTA: a query block-row of bm rows is split over bm / RQ CTAs
MAX_QUERY_ROWS = 16
# shared memory one CTA may use on Hopper (bytes)
MAX_SHARED_BYTES = 232448


@no_tf32()
def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, s_logical: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per query block-row, walk the key
    blocks with an online softmax (running max and sum per row), masked keys
    filled with ``finfo(float32).min`` and given weight exactly 0, then
    ``o / max(l, 1e-30)``.  ``q, k, v``: ``(..., gs, gd, bm, bd)``."""
    q, k, v = q.float(), k.float(), v.float()
    gs, bm = q.shape[-4], q.shape[-2]
    neg = torch.finfo(torch.float32).min
    lead_q = q.shape[:-4] + (gs, 1)  # the stats broadcast over the gd axis
    m = torch.full(lead_q + (bm, 1), neg, device=q.device)
    l = torch.zeros(lead_q + (bm, 1), device=q.device)
    o = None
    for j in range(gs):
        kj = k[..., j, :, :, :].unsqueeze(-4)  # (..., 1, gd, bm, bd)
        vj = v[..., j, :, :, :].unsqueeze(-4)
        # s[i][a, c] = sum_d q[i, d, a, :] . k[j, d, c, :]
        s = torch.einsum("...dab,...dcb->...ac", q, kj).unsqueeze(-3) * scale
        valid = (j * bm + torch.arange(bm, device=q.device)) < s_logical
        s = torch.where(valid, s, neg)  # (..., gs, 1, bm, bm)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("...ac,...dcb->...dab", p.squeeze(-3), vj)
        o = pv if o is None else o * alpha + pv
        m = m_new
    return o / torch.clamp(l, min=1e-30)


def _check(q, k, v, s_logical):
    if q.dim() < 4:
        raise ValueError(f"bwma_attention: q needs 4 blocked dims, got {tuple(q.shape)}")
    if k.shape[-4:] != q.shape[-4:] or v.shape[-4:] != q.shape[-4:]:
        raise ValueError(f"q/k/v blocked shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    gs, gd, bm, bd = q.shape[-4:]
    if not 1 <= s_logical <= gs * bm:
        raise ValueError(f"bwma_attention: s_logical {s_logical} outside 1..{gs * bm}")
    _build.check_operands("bwma_attention", q, k, v)
    _build.check_block("bwma_attention", bm, bd)
    grid = lead_grid((q, k, v), (4, 4, 4))
    if grid.size > 65535:
        raise ValueError(f"bwma_attention: too many leading slots {grid.shape}")
    return (gs, gd, bm, bd), grid


def bwma_attention(q, k, v, *, scale: float, s_logical: int | None = None):
    """softmax(q @ k^T * scale) @ v, entirely in BWMA order.

    q/k/v: ``(..., gs, gd, b, b)`` blocked matrices of logical shape
    ``(seq, d_head)`` -- raw tensors (``s_logical`` required) or
    :class:`Blocked` wrappers.  Leading dims (batch, heads) broadcast.  CUDA
    tensors launch the kernel; CPU tensors take :func:`attention_plain`.
    """
    wrapped = isinstance(q, Blocked)
    if wrapped != isinstance(k, Blocked) or wrapped != isinstance(v, Blocked):
        raise TypeError("pass q/k/v all as Blocked or all as raw blocked arrays")
    qa = q.data if wrapped else q
    ka = k.data if wrapped else k
    va = v.data if wrapped else v
    if s_logical is None:
        if not wrapped:
            raise ValueError("s_logical is required for raw blocked arrays")
        s_logical = q.shape[0]
    (gs, gd, bm, bd), grid = _check(qa, ka, va, s_logical)
    if _build.on_cuda("bwma_attention", qa, ka, va):
        rq = min(bm, MAX_QUERY_ROWS)
        lib = _build.library()
        smem = lib.bwma_attention_smem_bytes(gd, bm, bd, rq)
        if smem > MAX_SHARED_BYTES or rq * gd * bd > 16 * 256:
            raise ValueError(f"bwma_attention: padded d_head {gd * bd} at block {bm} "
                             f"needs {smem} bytes of shared memory per CTA; the "
                             f"limit is {MAX_SHARED_BYTES}")
        out = torch.empty(*grid.shape, gs, gd, bm, bd, dtype=torch.float32,
                          device=qa.device)
        (q0, q1), (k0, k1), (v0, v1) = grid.strides
        with torch.cuda.device(qa.device):
            pq, pk, pv, po = _build.launch_args(qa, ka, va, out)
            code = lib.bwma_attention_f32(
                pq, pk, pv, po, *grid.dims, q0, q1, k0, k1, v0, v1,
                gs, gd, bm, bd, rq, s_logical, float(scale), _build.stream(qa.device))
        _build.check(code, "bwma_attention")
        bwma_attention.launches += 1
    else:
        out = attention_plain(qa, ka, va, scale=scale, s_logical=s_logical)
    if wrapped:
        return Blocked(out, q.shape, q.layout)
    return out


bwma_attention.launches = 0
