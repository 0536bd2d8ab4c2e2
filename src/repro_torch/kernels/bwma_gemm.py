"""BWMA blocked GEMM: the CUDA kernel ``csrc/bwma_gemm.cu`` and its plain version.

Counterpart of ``repro.kernels.bwma_gemm``.  Operands are stored block-wise
(trailing dims = one block), so each block the kernel loads is one
contiguous run of memory -- the paper's arrangement.  Leading dims (batch,
heads) broadcast and become launch-grid dims; weights without leading dims
are shared, not replicated (:mod:`repro_torch.kernels.batching`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.blockwise import Blocked, gelu, no_tf32
from repro_torch.kernels import _build
from repro_torch.kernels.batching import lead_grid


@no_tf32()
def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same loop over the k-blocks
    into an fp32 accumulator, then (with ``bias``) the bias + tanh-GELU
    epilogue.  ``(..., gm, gk, bm, bk) @ (..., gk, gn, bk, bn)``."""
    a, b = a.float(), b.float()
    acc = None
    for kb in range(a.shape[-3]):
        # (..., gm, 1, bm, bk) @ (..., 1, gn, bk, bn) -> (..., gm, gn, bm, bn)
        t = torch.matmul(a[..., kb, :, :].unsqueeze(-3), b[..., kb, :, :, :].unsqueeze(-4))
        acc = t if acc is None else acc + t
    if bias is not None:
        acc = gelu(acc + bias.float()[:, None, :])
    return acc


def check_gemm(kernel: str, a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor]):
    """Check the operands the kernel takes, on either device; return
    ``((gm, gn, gk, bm, bn, bk), lead grid)``."""
    if a.dim() < 4 or b.dim() < 4:
        raise ValueError(f"{kernel}: blocked operands need 4 trailing dims, "
                         f"got {tuple(a.shape)} @ {tuple(b.shape)}")
    gm, gk, bm, bk = a.shape[-4:]
    gk2, gn, bk2, bn = b.shape[-4:]
    if (gk, bk) != (gk2, bk2):
        raise ValueError(f"{kernel}: inner blocks mismatch: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    operands = (a, b) if bias is None else (a, b, bias)
    _build.check_operands(kernel, *operands)
    _build.check_block(kernel, bm, bn, bk)
    if bias is not None and tuple(bias.shape) != (gn, bn):
        raise ValueError(f"{kernel}: bias must be blocked ({gn}, {bn}), "
                         f"got {tuple(bias.shape)}")
    grid = lead_grid((a, b), (4, 4))
    if gm > 65535 or grid.size > 65535:
        raise ValueError(f"{kernel}: grid too large (gm={gm}, lead={grid.shape})")
    return (gm, gn, gk, bm, bn, bk), grid


def launch_gemm(kernel: str, a: torch.Tensor, b: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch ``csrc/bwma_gemm.cu`` (the fused variant when ``bias`` is given)
    on CUDA tensors; returns the fp32 output.  Does not synchronise."""
    (gm, gn, gk, bm, bn, bk), grid = check_gemm(kernel, a, b, bias)
    out = torch.empty(*grid.shape, gm, gn, bm, bn, dtype=torch.float32, device=a.device)
    (sa0, sa1), (sb0, sb1) = grid.strides
    lib = _build.library()
    with torch.cuda.device(a.device):
        if bias is None:
            pa, pb, po = _build.launch_args(a, b, out)
            code = lib.bwma_gemm_f32(
                pa, pb, po, *grid.dims, sa0, sa1, sb0, sb1,
                gm, gn, gk, bm, bn, bk, _build.stream(a.device))
        else:
            pa, pb, pc, po = _build.launch_args(a, b, bias, out)
            code = lib.bwma_fused_ffn_f32(
                pa, pb, pc, po, *grid.dims, sa0, sa1, sb0, sb1,
                gm, gn, gk, bm, bn, bk, _build.stream(a.device))
    _build.check(code, kernel)
    return out


def bwma_gemm(a_blocked, b_blocked):
    """(..., gm, gk, bm, bk) @ (..., gk, gn, bk, bn) -> (..., gm, gn, bm, bn).

    Accepts raw blocked tensors or :class:`Blocked` wrappers (the result
    type follows the inputs); the operands and the result are fp32.  CUDA
    tensors launch the kernel; CPU tensors take :func:`gemm_plain`.
    """
    wrapped = isinstance(a_blocked, Blocked)
    if wrapped != isinstance(b_blocked, Blocked):
        raise TypeError("pass both operands as Blocked or both as raw blocked arrays")
    a, b = a_blocked, b_blocked
    if wrapped:
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
        a, b = a_blocked.data, b_blocked.data
    if _build.on_cuda("bwma_gemm", a, b):
        out = launch_gemm("bwma_gemm", a, b, None)
        bwma_gemm.launches += 1
    else:
        check_gemm("bwma_gemm", a, b, None)
        out = gemm_plain(a, b)
    if wrapped:
        return Blocked(out, (a_blocked.shape[0], b_blocked.shape[1]), a_blocked.layout)
    return out


bwma_gemm.launches = 0
