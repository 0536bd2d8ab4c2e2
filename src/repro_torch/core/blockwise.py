"""Block-wise (BWMA) operators, plain PyTorch reference semantics.

Counterpart of ``repro.core.blockwise``: every operator a transformer encoder
needs, computed directly on the blocked layout, so intermediates never go
back to row-major between layers (paper §3.2).  These are the math of the
``"reference"`` backend; the CUDA kernels in :mod:`repro_torch.kernels`
are held against them.

A :class:`Blocked` value carries the blocked data plus the logical
(unpadded) shape, so padded rows/columns can be masked in the reductions
(softmax / layernorm).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.layout import BlockLayout, from_blockwise, to_blockwise


@dataclasses.dataclass(frozen=True)
class Blocked:
    """A logically (m, n) matrix stored block-wise as (..., gm, gn, bm, bn)."""

    data: torch.Tensor  # (..., gm, gn, bm, bn)
    shape: Tuple[int, int]  # logical (m, n)
    layout: BlockLayout

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def unblock(self) -> torch.Tensor:
        return from_blockwise(self.data, self.layout, self.shape)


@contextlib.contextmanager
def no_tf32():
    """Run fp32 products in full fp32 on CUDA: TF32 keeps about three decimal
    digits and would break parity with the fp32 reference.  Sets
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False and restores them after;
    usable as a decorator."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def block(x: torch.Tensor, layout: BlockLayout) -> Blocked:
    return Blocked(to_blockwise(x, layout), (x.shape[-2], x.shape[-1]), layout)


def _col_mask(b: Blocked) -> torch.Tensor:
    """(gn, 1, bn) mask of valid (unpadded) logical columns."""
    gm, gn, bm, bn = b.data.shape[-4:]
    col = torch.arange(gn * bn, device=b.data.device).reshape(gn, 1, bn)
    return col < b.shape[1]


@no_tf32()
def bw_matmul(a: Blocked, b: Blocked) -> Blocked:
    """Blocked GEMM: every (i, j, k) step is one block matmul.

    K-padding is zeros so it contributes nothing to the accumulation.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    out = torch.einsum("...mkab,...knbc->...mnac", a.data, b.data)
    return Blocked(out, (a.shape[0], b.shape[1]), a.layout)


def bw_add(a: Blocked, b: Blocked) -> Blocked:
    return Blocked(a.data + b.data, a.shape, a.layout)


def bw_bias(a: Blocked, bias_blocked: torch.Tensor) -> Blocked:
    """bias_blocked: (gn, bn) — a bias vector stored block-wise."""
    return Blocked(a.data + bias_blocked[None, :, None, :], a.shape, a.layout)


def bw_map(a: Blocked, fn: Callable[[torch.Tensor], torch.Tensor]) -> Blocked:
    """Element-wise op (paper's Activation case: layout-neutral)."""
    return Blocked(fn(a.data), a.shape, a.layout)


def bw_scale(a: Blocked, s) -> Blocked:
    return Blocked(a.data * s, a.shape, a.layout)


def bw_transpose(a: Blocked) -> Blocked:
    """Paper §3.2 Transpose: swap the block grid *and* each block's interior."""
    out = a.data.transpose(-4, -3).transpose(-2, -1)
    lo = BlockLayout(a.layout.bn, a.layout.bm)  # block interior swaps too
    return Blocked(out, (a.shape[1], a.shape[0]), lo)


def bw_softmax(a: Blocked, *, where_extra=None) -> Blocked:
    """Softmax over logical rows of a blocked matrix (paper §3.2 Softmax).

    The reduction runs over axes (gn, bn) with padded columns masked out and
    filled with ``finfo(dtype).min``.  Padded rows stay finite garbage that
    is cropped at unblock time.
    """
    mask = _col_mask(a)  # (gn, 1, bn)
    if where_extra is not None:
        mask = torch.logical_and(mask, where_extra)
    neg = torch.finfo(a.dtype).min
    x = torch.where(mask, a.data, neg)
    m = torch.amax(x, dim=(-3, -1), keepdim=True)
    e = torch.where(mask, torch.exp(x - m), 0.0)
    s = torch.sum(e, dim=(-3, -1), keepdim=True)
    return Blocked(e / torch.clamp(s, min=1e-30), a.shape, a.layout)


def bw_layernorm(
    a: Blocked,
    gamma_blocked: torch.Tensor,
    beta_blocked: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> Blocked:
    """Row-wise LayerNorm on the blocked layout (paper §3.2 Normalization).

    gamma/beta are stored block-wise as (gn, bn); padded columns come out 0.
    """
    mask = _col_mask(a)
    n = a.shape[1]
    x = torch.where(mask, a.data, 0.0)
    mean = torch.sum(x, dim=(-3, -1), keepdim=True) / n
    var = torch.sum(torch.where(mask, (a.data - mean) ** 2, 0.0),
                    dim=(-3, -1), keepdim=True) / n
    y = (a.data - mean) * torch.rsqrt(var + eps)
    y = y * gamma_blocked[None, :, None, :] + beta_blocked[None, :, None, :]
    return Blocked(torch.where(mask, y, 0.0), a.shape, a.layout)


def bw_attention(q: Blocked, k: Blocked, v: Blocked, *, scale) -> Blocked:
    """Reference attention ``softmax(q @ k^T * scale) @ v``, blocked.

    The score matrix is materialized here; the point of the kernel is that
    it never is.
    """
    scores = bw_scale(bw_matmul(q, bw_transpose(k)), scale)
    return bw_matmul(bw_softmax(scores), v)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU, which is ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def add_head_axis(x: Blocked) -> Blocked:
    """Insert a broadcasting head axis before the 4 blocked dims."""
    return Blocked(x.data.unsqueeze(-5), x.shape, x.layout)


def merge_heads(ctx: Blocked) -> Blocked:
    """(..., h, gs, gd, b, b) per-head outputs -> (..., gs, h*gd, b, b).

    Stacks the heads along the column-grid axis.  When ``d_head`` is not a
    block multiple, each head keeps its zero padding *inside* the merged
    matrix, so the declared logical width is ``h * ceil(d_head / bn) * bn``;
    the output projection is blocked per head the same way (see
    ``encoder.block_layer_params``) so the interior zeros cancel in the GEMM.
    """
    s, _ = ctx.shape
    data = ctx.data
    h = data.shape[-5]
    dh_padded = data.shape[-3] * data.shape[-1]  # gd * bn
    data = data.movedim(-5, -4)  # (..., gs, h, gd, b, b)
    # contiguous: stored block after block (a view when gd == 1 would not be)
    data = data.reshape(*data.shape[:-4], h * data.shape[-3], *data.shape[-2:]).contiguous()
    return Blocked(data, (s, h * dh_padded), ctx.layout)


def block_vector(v: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """Store a length-N vector block-wise as (gn, bn) (zero padded)."""
    n = v.shape[-1]
    gn = -(-n // layout.bn)
    pad = gn * layout.bn - n
    if pad:
        v = F.pad(v, (0, pad))
    return v.reshape(*v.shape[:-1], gn, layout.bn)
