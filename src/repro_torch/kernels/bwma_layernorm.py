"""Blocked LayerNorm (paper §3.2 Normalization): ``csrc/bwma_layernorm.cu``
and its plain version.

Counterpart of ``repro.kernels.bwma_layernorm``.  gamma/beta are stored
block-wise as (gn, bn), so the residual + norm path never leaves block order.
"""
from __future__ import annotations

import torch

from repro_torch.core.blockwise import Blocked
from repro_torch.kernels import _build
from repro_torch.kernels.batching import lead_grid


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    n_logical: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel: masked mean, then masked
    variance over the first ``n_logical`` columns of each logical row,
    ``rsqrt(var + eps)``, gamma/beta, padded columns written as 0."""
    x = x.float()
    gn, bn = x.shape[-3], x.shape[-1]
    col = torch.arange(gn * bn, device=x.device).reshape(gn, 1, bn)
    mask = col < n_logical
    mean = torch.where(mask, x, 0.0).sum(dim=(-3, -1), keepdim=True) / n_logical
    var = torch.where(mask, (x - mean) ** 2, 0.0).sum(dim=(-3, -1), keepdim=True) / n_logical
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * gamma.float()[:, None, :] + beta.float()[:, None, :]
    return torch.where(mask, y, 0.0)


def _check(x, gamma, beta, n_logical):
    if x.dim() < 4:
        raise ValueError(f"bwma_layernorm: x needs 4 blocked dims, got {tuple(x.shape)}")
    gm, gn, bm, bn = x.shape[-4:]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (gn, bn):
            raise ValueError(f"bwma_layernorm: {name} must be blocked ({gn}, {bn}), "
                             f"got {tuple(t.shape)}")
    if not 1 <= n_logical <= gn * bn:
        raise ValueError(f"bwma_layernorm: n_logical {n_logical} outside 1..{gn * bn}")
    _build.check_operands("bwma_layernorm", x, gamma, beta)
    _build.check_block("bwma_layernorm", bm, bn)
    grid = lead_grid((x,), (4,))
    if grid.size > 65535:
        raise ValueError(f"bwma_layernorm: too many leading slots {grid.shape}")
    return (gm, gn, bm, bn), grid


def bwma_layernorm(x_blocked, gamma_blocked: torch.Tensor, beta_blocked: torch.Tensor,
                   n_logical: int | None = None, *, eps: float = 1e-5):
    """Row LayerNorm on a (..., gm, gn, bm, bn) blocked matrix.

    gamma/beta are blocked vectors ``(gn, bn)`` shared across all leading
    dims.  Accepts a raw blocked tensor (``n_logical`` required) or a
    :class:`Blocked` wrapper.  CUDA tensors launch the kernel; CPU tensors
    take :func:`layernorm_plain`.
    """
    wrapped = isinstance(x_blocked, Blocked)
    x = x_blocked.data if wrapped else x_blocked
    if n_logical is None:
        if not wrapped:
            raise ValueError("n_logical is required for raw blocked arrays")
        n_logical = x_blocked.shape[1]
    (gm, gn, bm, bn), grid = _check(x, gamma_blocked, beta_blocked, n_logical)
    if _build.on_cuda("bwma_layernorm", x, gamma_blocked, beta_blocked):
        out = torch.empty_like(x)
        lib = _build.library()
        with torch.cuda.device(x.device):
            px, pg, pb, po = _build.launch_args(x, gamma_blocked, beta_blocked, out)
            (s0, s1), = grid.strides
            code = lib.bwma_layernorm_f32(
                px, pg, pb, po, *grid.dims, s0, s1, gm, gn, bm, bn, n_logical,
                eps, _build.stream(x.device))
        _build.check(code, "bwma_layernorm")
        bwma_layernorm.launches += 1
    else:
        out = layernorm_plain(x, gamma_blocked, beta_blocked, n_logical, eps)
    if wrapped:
        return Blocked(out, x_blocked.shape, x_blocked.layout)
    return out


bwma_layernorm.launches = 0
