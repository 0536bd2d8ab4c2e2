"""Public convenience wrappers around the CUDA kernels.

Counterpart of ``repro.kernels.ops``.  They adapt between the logical (2-D)
world and the blocked (BWMA) world and run where their tensors live: the
kernels for CUDA tensors, their plain versions for CPU tensors.

Dtype contract, as in the JAX package: the element-wise-shaped ops
(layernorm/attention) preserve the input dtype; the GEMM-shaped ops
(``blocked_matmul``, ``blocked_ffn``) return the **f32 accumulator** unless
``out_dtype`` says otherwise.

``blocked_softmax`` waits for its kernel (``bwma_softmax``: ROADMAP.md
queue 2 item 9).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.backend import resolve_backend
from repro_torch.core.blockwise import Blocked
from repro_torch.core.layout import BlockLayout, from_blockwise, to_blockwise
from repro_torch.kernels.bwma_fused_ffn import bwma_fused_ffn
from repro_torch.kernels.bwma_gemm import bwma_gemm
from repro_torch.kernels.rwma_gemm import rwma_gemm


def blocked_matmul(a: Blocked, b: Blocked, out_dtype: Optional[torch.dtype] = None) -> Blocked:
    """BWMA GEMM; returns the f32 accumulator unless ``out_dtype`` is given."""
    out = bwma_gemm(a.data, b.data)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return Blocked(out, (a.shape[0], b.shape[1]), a.layout)


def blocked_layernorm(a: Blocked, gamma_blocked, beta_blocked) -> Blocked:
    return resolve_backend("cuda").layernorm(a, gamma_blocked, beta_blocked)


def blocked_ffn(a: Blocked, w: Blocked, bias_blocked,
                out_dtype: Optional[torch.dtype] = None) -> Blocked:
    """Fused GEMM+bias+GELU; f32 accumulator unless ``out_dtype`` is given."""
    out = bwma_fused_ffn(a.data, w.data, bias_blocked)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return Blocked(out, (a.shape[0], w.shape[1]), a.layout)


def blocked_attention(q: Blocked, k: Blocked, v: Blocked, *, scale: float) -> Blocked:
    """Fused softmax(q @ k^T * scale) @ v without leaving BWMA order."""
    return resolve_backend("cuda").attention(q, k, v, scale=scale)


def matmul_rwma(a: torch.Tensor, b: torch.Tensor, bm: int = 128, bk: int = 128,
                bn: int = 128) -> torch.Tensor:
    """Row-major tiled GEMM -- the RWMA baseline kernel; f32 result."""
    return rwma_gemm(a, b, bm=bm, bk=bk, bn=bn)


def matmul_bwma_2d(a: torch.Tensor, b: torch.Tensor,
                   layout: Optional[BlockLayout] = None) -> torch.Tensor:
    """Convenience: 2-D in, 2-D out, blocked internally (conversion at edges
    only -- mirrors the paper's whole-model I/O conversion)."""
    layout = layout or BlockLayout(128, 128)
    ab = to_blockwise(a, BlockLayout(layout.bm, layout.bn))
    bb = to_blockwise(b, BlockLayout(layout.bn, layout.bn))
    out = bwma_gemm(ab, bb)
    return from_blockwise(out, layout, (a.shape[0], b.shape[1]))
