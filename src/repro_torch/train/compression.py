"""Gradient compression: int8 with a per-leaf fp32 scale.

Counterpart of ``repro.train.compression``'s quantizer::

    scale = max|g| / 127 + 1e-12     (per leaf)
    q     = round(g / scale)  in int8, clipped to [-127, 127]
    g'    = q * scale

The trainer's ``grad_compression="int8"`` runs this round trip on the
gradients after their reduction, as the JAX trainer does (the wire
format's error; on a mesh each leaf's scale is its whole leaf's, the
maximum over the ranks holding its shards).  :func:`compressed_psum`
reduces int8 gradients over a process group (the JAX package's, over the
data-parallel axes of a ``shard_map``): the scale reduced by MAX, the int8
values summed in int32, the mean taken by the group's size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_leaf(g: torch.Tensor, scale=None):
    """(int8 values, the fp32 scale): the leaf's own scale, or ``scale``
    where given (a scale shared with other ranks)."""
    gf = g.float()
    if scale is None:
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(grads, group=None):
    """The mean of a list of gradient tensors over ``group`` (default: the
    default group) with an int8 wire format, as the JAX package's
    ``compressed_psum``: each leaf's scale is the group's largest
    (``all_reduce`` MAX), its int8 values are summed in int32, and the sum
    times the scale is divided by the group's size."""
    n = dist.get_world_size(group)
    out = []
    for g in grads:
        _, scale = quantize_leaf(g)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        total = quantize_leaf(g, scale)[0].to(torch.int32)
        dist.all_reduce(total, group=group)
        out.append((total.float() * scale / n).to(g.dtype))
    return out
