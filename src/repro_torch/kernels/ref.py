"""Plain row-major oracles for the kernels, in PyTorch.

Counterpart of ``repro.kernels.ref``.  Each oracle operates on *logical*
(row-major / RWMA) tensors; the kernels operate on blocked (BWMA) tensors.
Tests block the inputs, run the kernel, unblock the output and compare.
"""
from __future__ import annotations

import torch

from repro_torch.core.blockwise import gelu, no_tf32


@no_tf32()
def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def softmax_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x.float(), dim=-1)


def layernorm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def ffn_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused GEMM + bias + GELU (paper §3.2 Activation: fused at write-back)."""
    return gelu(matmul_ref(x, w) + b.float())
