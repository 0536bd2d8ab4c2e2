"""Blocked LayerNorm (paper §3.2 Normalization): ``csrc/bwma_layernorm.cu``
and its plain version.

Counterpart of ``repro.kernels.bwma_layernorm``.  gamma/beta are stored
block-wise as (gn, bn), so the residual + norm path never leaves block order.
x is fp32 or bf16, gamma and beta each fp32 or bf16; the norm is computed in
fp32 and the result has x's type, as in the JAX kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.blockwise import Blocked
from repro_torch.kernels import _build
from repro_torch.kernels.batching import lead_grid

# the 16-byte vectors a lane holds on the kernel's register path (its NV)
VECTORS_PER_LANE = (1, 2, 4, 8, 16)


def layernorm_plan(n: int, dtype: torch.dtype) -> Tuple[int, bool]:
    """The kernel's walk of a logical row of padded width ``n`` (``gn * bn``
    columns) of ``dtype``: ``(vectors_per_lane, looped)``.

    One warp owns a row (4 rows to a CTA, fixed in the CUDA source).  A lane
    holds ``vectors_per_lane`` 16-byte vectors of its row, the power of two
    that covers the row; above 16 (2048 fp32 or 4096 bf16 columns) the row
    takes the looped path, and ``vectors_per_lane`` is then the number of
    vectors a lane walks per pass."""
    per_lane = -(-n * dtype.itemsize // (16 * 32))
    looped = per_lane > VECTORS_PER_LANE[-1]
    if not looped:
        per_lane = next(v for v in VECTORS_PER_LANE if v >= per_lane)
    return per_lane, looped


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    n_logical: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel: masked mean, then masked
    variance over the first ``n_logical`` columns of each logical row,
    ``rsqrt(var + eps)``, gamma/beta, padded columns written as 0; in fp32,
    rounded once to ``x.dtype``."""
    dtype, x = x.dtype, x.float()
    gn, bn = x.shape[-3], x.shape[-1]
    col = torch.arange(gn * bn, device=x.device).reshape(gn, 1, bn)
    mask = col < n_logical
    mean = torch.where(mask, x, 0.0).sum(dim=(-3, -1), keepdim=True) / n_logical
    var = torch.where(mask, (x - mean) ** 2, 0.0).sum(dim=(-3, -1), keepdim=True) / n_logical
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * gamma.float()[:, None, :] + beta.float()[:, None, :]
    return torch.where(mask, y, 0.0).to(dtype)


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


def launch_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     n_logical: int, eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/bwma_layernorm.cu`` on CUDA tensors with the plan of
    :func:`layernorm_plan`; returns the output in x's type.  Does not
    synchronise."""
    (gm, gn, bm, bn), grid = _check(x, gamma, beta, n_logical)
    per_lane, looped = layernorm_plan(gn * bn, x.dtype)
    out = torch.empty_like(x)
    bf16 = torch.bfloat16
    with torch.cuda.device(x.device):
        px, pg, pb, po = _build.launch_args(x, gamma, beta, out)
        (s0, s1), = grid.strides
        code = _build.library().bwma_layernorm(
            px, pg, pb, po, x.dtype == bf16, gamma.dtype == bf16, beta.dtype == bf16,
            *grid.dims, s0, s1, gm, gn, bm, bn, n_logical, eps, 0 if looped else per_lane,
            _build.stream(x.device))
    _build.check(code, "bwma_layernorm")
    return out


def bwma_layernorm(x_blocked, gamma_blocked: torch.Tensor, beta_blocked: torch.Tensor,
                   n_logical: int | None = None, *, eps: float = 1e-5):
    """Row LayerNorm on a (..., gm, gn, bm, bn) blocked matrix.

    gamma/beta are blocked vectors ``(gn, bn)`` shared across all leading
    dims.  Accepts a raw blocked tensor (``n_logical`` required) or a
    :class:`Blocked` wrapper.  The result has x's type.  CUDA tensors launch
    the kernel; CPU tensors take :func:`layernorm_plain`.
    """
    wrapped = isinstance(x_blocked, Blocked)
    x = x_blocked.data if wrapped else x_blocked
    if n_logical is None:
        if not wrapped:
            raise ValueError("n_logical is required for raw blocked arrays")
        n_logical = x_blocked.shape[1]
    x, gamma, beta = _build.operands(x, gamma_blocked, beta_blocked, aligned=True)
    if _build.on_cuda("bwma_layernorm", x, gamma, beta):
        out = launch_layernorm(x, gamma, beta, n_logical, eps)
        bwma_layernorm.launches += 1
    else:
        _check(x, gamma, beta, n_logical)
        out = layernorm_plain(x, gamma, beta, n_logical, eps)
    if wrapped:
        return Blocked(out, x_blocked.shape, x_blocked.layout)
    return out


bwma_layernorm.launches = 0
