"""Blocked transpose (paper §3.2 Transpose): ``csrc/bwma_transpose.cu`` and
its plain version.

Counterpart of ``repro.kernels.bwma_transpose``.  In BWMA a transpose is two
nested small transposes: swap the block-grid coordinates and transpose each
block's interior.  Every block moves as one contiguous run in both
directions -- the paper's Fig. 5b locality argument.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.blockwise import Blocked
from repro_torch.core.layout import BlockLayout
from repro_torch.kernels import _build

WORD_BYTES = (1, 2, 4, 8, 16)
# constants of csrc/bwma_transpose.cu: the bytes a CTA moves, and the most
# micro-tile rows of a tile
TILE_BYTES = 8192
MAX_TILE_ROWS = 16


class TransposePlan(NamedTuple):
    """A launch of the kernel: every load and store moves a ``word`` of
    bytes; a CTA moves ``tile_blocks`` whole source blocks, or (with
    ``tile_blocks`` 1) a ``tile_rows`` x ``tile_cols`` sub-tile of one
    block; ``ctas`` CTAs in all."""
    word: int
    tile_blocks: int
    tile_rows: int
    tile_cols: int
    ctas: int


@functools.lru_cache(maxsize=None)
def transpose_plan(gm: int, gn: int, bm: int, bn: int, elem_size: int, lead: int = 1,
                   align: int = 16) -> TransposePlan:
    """The kernel's tiling of ``lead`` blocked matrices of (gm, gn) blocks of
    bm x bn elements of ``elem_size`` bytes, at an input address that is a
    multiple of ``align`` bytes.

    The word is the widest of 16, 8, 4, 2 and 1 bytes that divides a source
    row, an output row and the address, so that a thread moves a V x V
    micro-tile (V = word / elem_size) as V words.  A CTA moves at most
    ``TILE_BYTES``: as many whole blocks as fit where a block has at most
    ``MAX_TILE_ROWS`` micro-tile rows, else a sub-tile of one block of at
    most that many micro-tile rows, as wide as the bytes allow."""
    word = WORD_BYTES[-1]
    while word > elem_size and ((bm * elem_size) % word or (bn * elem_size) % word
                                or align % word):
        word //= 2
    v = word // elem_size
    mr, mc = bm // v, bn // v  # micro-tiles of a block
    per_cta = TILE_BYTES // (v * word)  # micro-tiles of a tile
    if mr <= MAX_TILE_ROWS and mr * mc <= per_cta:
        nb, sr, sc = per_cta // (mr * mc), mr, mc
    else:
        nb, sr = 1, min(mr, MAX_TILE_ROWS)
        sc = min(mc, per_cta // sr)
    ctas = -(-lead * gm * gn // nb) * -(-mr // sr) * -(-mc // sc)
    return TransposePlan(word, nb, sr * v, sc * v, ctas)


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(..., gm, gn, bm, bn) -> (..., gn, gm, bn,
    bm)``, a contiguous copy."""
    return x.transpose(-4, -3).transpose(-2, -1).contiguous()


def bwma_transpose(x_blocked):
    """Logical transpose of a (..., gm, gn, bm, bn) blocked matrix, bit-exact
    for any element type.

    Accepts a raw blocked tensor or a :class:`Blocked` wrapper, which comes
    back with the swapped logical shape and layout.  CUDA tensors launch the
    kernel (a view on a contiguous copy) with the tiling of
    :func:`transpose_plan`; CPU tensors take :func:`transpose_plain`.
    """
    wrapped = isinstance(x_blocked, Blocked)
    x = x_blocked.data if wrapped else x_blocked
    if x.dim() < 4:
        raise ValueError(f"bwma_transpose: x needs 4 blocked dims, got {tuple(x.shape)}")
    if _build.on_cuda("bwma_transpose", x):
        # a view is copied; an unaligned one is not: the plan narrows its word
        x, = _build.operands(x)
        esz = x.element_size()
        if esz not in WORD_BYTES or x.data_ptr() % esz:
            raise TypeError(f"bwma_transpose: {x.dtype} elements at address "
                            f"{x.data_ptr():#x} do not move as {WORD_BYTES}-byte words")
        gm, gn, bm, bn = x.shape[-4:]
        lead = math.prod(x.shape[:-4])
        ptr = x.data_ptr()
        plan = transpose_plan(gm, gn, bm, bn, esz, lead, min(16, ptr & -ptr))
        out = torch.empty((*x.shape[:-4], gn, gm, bn, bm), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            code = _build.library().bwma_transpose(
                ptr, out.data_ptr(), esz, plan.word, lead * gm * gn, gm, gn, bm, bn,
                plan.tile_blocks, plan.tile_rows, plan.tile_cols, _build.stream(x.device))
        _build.check(code, "bwma_transpose")
        bwma_transpose.launches += 1
    else:
        out = transpose_plain(x)
    if wrapped:
        layout = BlockLayout(x_blocked.layout.bn, x_blocked.layout.bm)
        return Blocked(out, (x_blocked.shape[1], x_blocked.shape[0]), layout)
    return out


bwma_transpose.launches = 0
