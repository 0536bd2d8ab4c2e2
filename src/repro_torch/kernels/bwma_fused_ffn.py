"""Blocked GEMM + bias + GELU fusion (paper §3.2 Activation).

Counterpart of ``repro.kernels.bwma_fused_ffn``.  The activation is
element-wise, so it is applied to the accumulator while it is still in
registers, before the single store: the epilogue variant of
``csrc/bwma_gemm.cu`` (template flag ``FUSED``).
"""
from __future__ import annotations

import torch

from repro_torch.core.blockwise import Blocked
from repro_torch.kernels import _build
from repro_torch.kernels.bwma_gemm import check_gemm, gemm_plain, launch_gemm


def ffn_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the GEMM's k-block loop, then tanh-GELU of
    accumulator + bias."""
    return gemm_plain(a, w, bias)


def bwma_fused_ffn(a_blocked, w_blocked, bias_blocked: torch.Tensor):
    """gelu((..., gm,gk,bm,bk) @ (gk,gn,bk,bn) + bias(gn,bn)) -> (..., gm,gn,bm,bn).

    Accepts raw blocked tensors (returns the fp32 result) or :class:`Blocked`
    wrappers for the matrix operands (the result cast back to the input
    dtype); the bias stays a raw blocked vector shared by every leading
    slot.  Operands are fp32 or bf16, summed in fp32.  CUDA tensors launch the kernel; CPU
    tensors take :func:`ffn_plain`.
    """
    wrapped = isinstance(a_blocked, Blocked)
    if wrapped != isinstance(w_blocked, Blocked):
        raise TypeError("pass both matrix operands as Blocked or both as raw blocked arrays")
    a = a_blocked.data if wrapped else a_blocked
    w = w_blocked.data if wrapped else w_blocked
    if _build.on_cuda("bwma_fused_ffn", a, w, bias_blocked):
        out = launch_gemm("bwma_fused_ffn", a, w, bias_blocked)
        bwma_fused_ffn.launches += 1
    else:
        check_gemm("bwma_fused_ffn", a, w, bias_blocked)
        out = ffn_plain(a, w, bias_blocked)
    if wrapped:
        return Blocked(out.to(a_blocked.dtype), (a_blocked.shape[0], w_blocked.shape[1]),
                       a_blocked.layout)
    return out


bwma_fused_ffn.launches = 0
