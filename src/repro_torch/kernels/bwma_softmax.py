"""Blocked softmax (paper §3.2 Softmax): ``csrc/bwma_softmax.cu`` and its
plain version.

Counterpart of ``repro.kernels.bwma_softmax``.  The reduction over a logical
row spans axes (gn, bn) of its block-row; padded columns (the block
quantisation of the logical width) are masked with the index arithmetic of
the paper's Fig. 5a and written as 0.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.blockwise import Blocked
from repro_torch.kernels import _build
from repro_torch.kernels.bwma_layernorm import layernorm_plan

SOFTMAX_DTYPES = (torch.float32, torch.bfloat16)


def softmax_plan(n: int, dtype: torch.dtype) -> Tuple[int, bool]:
    """The kernel's walk of a logical row of padded width ``n`` (``gn * bn``
    columns) of ``dtype``: ``(vectors_per_lane, looped)``.

    The LayerNorm kernel's walk, with the same register budget: one warp
    owns a row (4 rows to a CTA, fixed in the CUDA source) and a lane holds
    ``vectors_per_lane`` 16-byte vectors of it, the power of two that covers
    the row; above 16 (2048 fp32 or 4096 bf16 columns) the row takes the
    looped path, which reads it twice."""
    return layernorm_plan(n, dtype)


def softmax_plain(x: torch.Tensor, n_logical: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: columns at or past ``n_logical``
    take ``finfo(x.dtype).min`` in the row max and come out as 0; ``e / max(
    sum e, 1e-30)`` with ``e = exp(x - max)``, in fp32, rounded once to
    ``x.dtype``."""
    gn, bn = x.shape[-3], x.shape[-1]
    mask = torch.arange(gn * bn, device=x.device).reshape(gn, 1, bn) < n_logical
    xm = torch.where(mask, x.float(), torch.finfo(x.dtype).min)
    m = torch.amax(xm, dim=(-3, -1), keepdim=True)
    e = torch.where(mask, torch.exp(xm - m), 0.0)
    s = torch.sum(e, dim=(-3, -1), keepdim=True)
    return (e / torch.clamp(s, min=1e-30)).to(x.dtype)


def _check(x: torch.Tensor, n_logical: int):
    if x.dim() < 4:
        raise ValueError(f"bwma_softmax: x needs 4 blocked dims, got {tuple(x.shape)}")
    gm, gn, bm, bn = x.shape[-4:]
    if not 1 <= n_logical <= gn * bn:
        raise ValueError(f"bwma_softmax: n_logical {n_logical} outside 1..{gn * bn}")
    if x.dtype not in SOFTMAX_DTYPES:
        raise TypeError(f"bwma_softmax: x must be one of {SOFTMAX_DTYPES}, got {x.dtype}")
    return gm, gn, bm, bn


def bwma_softmax(x_blocked, n_logical: int | None = None):
    """Row softmax on a (..., gm, gn, bm, bn) blocked matrix, logical width n.

    Accepts a raw blocked tensor (``n_logical`` required) or a
    :class:`Blocked` wrapper (``n_logical`` defaults to its logical width).
    The output has the input's type (fp32 or bf16).  CUDA tensors launch
    the kernel (``bn`` in 8..128 powers of two; a view, or an operand off a
    16-byte address, on a contiguous copy: :func:`_build.operands`) with the
    plan of :func:`softmax_plan`; CPU tensors take :func:`softmax_plain`.
    """
    wrapped = isinstance(x_blocked, Blocked)
    x = x_blocked.data if wrapped else x_blocked
    if n_logical is None:
        if not wrapped:
            raise ValueError("n_logical is required for raw blocked arrays")
        n_logical = x_blocked.shape[1]
    gm, gn, bm, bn = _check(x, n_logical)
    if _build.on_cuda("bwma_softmax", x):
        _build.check_block("bwma_softmax", bn)
        x, = _build.operands(x, aligned=True)
        out = torch.empty_like(x)
        lib = _build.library()
        entry = lib.bwma_softmax_f32 if x.dtype == torch.float32 else lib.bwma_softmax_bf16
        block_rows = math.prod(x.shape[:-4]) * gm
        per_lane, looped = softmax_plan(gn * bn, x.dtype)
        with torch.cuda.device(x.device):
            code = entry(*_build.launch_args(x, out), block_rows, gn, bm, bn, n_logical,
                         0 if looped else per_lane, _build.stream(x.device))
        _build.check(code, "bwma_softmax")
        bwma_softmax.launches += 1
    else:
        out = softmax_plain(x, n_logical)
    if wrapped:
        return Blocked(out, x_blocked.shape, x_blocked.layout)
    return out


bwma_softmax.launches = 0
