"""Blocked transpose (paper §3.2 Transpose): ``csrc/bwma_transpose.cu`` and
its plain version.

Counterpart of ``repro.kernels.bwma_transpose``.  In BWMA a transpose is two
nested small transposes: swap the block-grid coordinates and transpose each
block's interior.  Every block moves as one contiguous run in both
directions -- the paper's Fig. 5b locality argument.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.blockwise import Blocked
from repro_torch.core.layout import BlockLayout
from repro_torch.kernels import _build

WORD_BYTES = (1, 2, 4, 8, 16)


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(..., gm, gn, bm, bn) -> (..., gn, gm, bn,
    bm)``, a contiguous copy."""
    return x.transpose(-4, -3).transpose(-2, -1).contiguous()


def bwma_transpose(x_blocked):
    """Logical transpose of a (..., gm, gn, bm, bn) blocked matrix, bit-exact
    for any element type.

    Accepts a raw blocked tensor or a :class:`Blocked` wrapper, which comes
    back with the swapped logical shape and layout.  CUDA tensors launch the
    kernel (contiguous); CPU tensors take :func:`transpose_plain`.
    """
    wrapped = isinstance(x_blocked, Blocked)
    x = x_blocked.data if wrapped else x_blocked
    if x.dim() < 4:
        raise ValueError(f"bwma_transpose: x needs 4 blocked dims, got {tuple(x.shape)}")
    if _build.on_cuda("bwma_transpose", x):
        if not x.is_contiguous():
            raise ValueError(f"bwma_transpose: operand of shape {tuple(x.shape)} "
                             "is not contiguous")
        esz = x.element_size()
        if esz not in WORD_BYTES or x.data_ptr() % esz:
            raise TypeError(f"bwma_transpose: {x.dtype} elements at address "
                            f"{x.data_ptr():#x} do not move as {WORD_BYTES}-byte words")
        gm, gn, bm, bn = x.shape[-4:]
        out = torch.empty((*x.shape[:-4], gn, gm, bn, bm), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            code = _build.library().bwma_transpose(
                x.data_ptr(), out.data_ptr(), esz, math.prod(x.shape[:-2]), gm, gn, bm, bn,
                _build.stream(x.device))
        _build.check(code, "bwma_transpose")
        bwma_transpose.launches += 1
    else:
        out = transpose_plain(x)
    if wrapped:
        layout = BlockLayout(x_blocked.layout.bn, x_blocked.layout.bm)
        return Blocked(out, (x_blocked.shape[1], x_blocked.shape[0]), layout)
    return out


bwma_transpose.launches = 0
