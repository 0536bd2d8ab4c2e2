"""Gradient compression: int8 with a per-leaf fp32 scale.

Counterpart of ``repro.train.compression``'s quantizer::

    scale = max|g| / 127 + 1e-12     (per leaf)
    q     = round(g / scale)  in int8, clipped to [-127, 127]
    g'    = q * scale

The trainer's ``grad_compression="int8"`` runs this round trip on the
gradients (the wire format's error, with no wire on one device).  The JAX
package's ``compressed_psum`` reduces the int8 gradients over the
data-parallel axes of a mesh; it needs a process group and waits for
the training mesh (ROADMAP.md queue 1 item 26, its training half).
"""
from __future__ import annotations

import torch


def quantize_leaf(g: torch.Tensor):
    """(int8 values, the fp32 scale)."""
    gf = g.float()
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
