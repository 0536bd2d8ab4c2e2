"""Block-wise memory arrangement (BWMA) layouts, on ``torch.Tensor``.

Counterpart of ``repro.core.layout``.  A 2-D matrix is stored as a 4-D
tensor ``(M/bm, N/bn, bm, bn)`` whose trailing two dims are one kernel
block, so each block is one contiguous run of memory (paper Fig. 4d).
:func:`to_blockwise` returns a contiguous tensor: the memory order, and not
only the index order, is the blocked one, which is what the CUDA kernels
read.

``RWMA`` is the conventional row-major 2-D tensor the paper compares against.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


class LayoutPolicy(enum.Enum):
    """Which arrangement a model/layer uses for its matrices."""

    RWMA = "rwma"  # conventional row-major
    BWMA = "bwma"  # paper's block-wise arrangement


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """A block-wise layout governed by the kernel block size ``bm`` x ``bn``."""

    bm: int = 128
    bn: int = 128

    def __post_init__(self):
        if self.bm <= 0 or self.bn <= 0:
            raise ValueError(f"block dims must be positive, got {self}")

    def padded_shape(self, shape: Tuple[int, int]) -> Tuple[int, int]:
        m, n = shape
        return (ceil_to(m, self.bm), ceil_to(n, self.bn))

    def grid(self, shape: Tuple[int, int]) -> Tuple[int, int]:
        pm, pn = self.padded_shape(shape)
        return (pm // self.bm, pn // self.bn)

    def blocked_shape(self, shape: Tuple[int, int]) -> Tuple[int, int, int, int]:
        gm, gn = self.grid(shape)
        return (gm, gn, self.bm, self.bn)


def ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


def pad2d(x: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """Zero-pad the trailing two dims of ``x`` to block multiples."""
    m, n = x.shape[-2], x.shape[-1]
    pm, pn = layout.padded_shape((m, n))
    if (pm, pn) == (m, n):
        return x
    return F.pad(x, (0, pn - n, 0, pm - m))


def to_blockwise(x: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """RWMA -> BWMA: ``(..., M, N) -> (..., M/bm, N/bn, bm, bn)``, contiguous."""
    x = pad2d(x, layout)
    *lead, m, n = x.shape
    gm, gn = m // layout.bm, n // layout.bn
    x = x.reshape(*lead, gm, layout.bm, gn, layout.bn)
    # (..., gm, bm, gn, bn) -> (..., gm, gn, bm, bn), stored block after block
    return x.transpose(-3, -2).contiguous()


def from_blockwise(
    xb: torch.Tensor, layout: BlockLayout, shape: Tuple[int, int]
) -> torch.Tensor:
    """BWMA -> RWMA, cropping any block padding back to ``shape``."""
    *lead, gm, gn, bm, bn = xb.shape
    if (bm, bn) != (layout.bm, layout.bn):
        raise ValueError(f"array blocks {(bm, bn)} != layout {(layout.bm, layout.bn)}")
    x = xb.transpose(-3, -2).reshape(*lead, gm * bm, gn * bn)
    m, n = shape
    return x[..., :m, :n]


def blockwise_1d_view(xb: np.ndarray) -> np.ndarray:
    """The literal 1-D array as stored in memory (paper Fig. 4d). numpy-only."""
    return np.ascontiguousarray(xb).reshape(-1)
