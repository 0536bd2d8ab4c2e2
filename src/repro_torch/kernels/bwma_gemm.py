"""BWMA blocked GEMM: the CUDA kernel ``csrc/bwma_gemm.cu`` and its plain version.

Counterpart of ``repro.kernels.bwma_gemm``.  Operands are stored block-wise
(trailing dims = one block), so each block the kernel loads is one
contiguous run of memory -- the paper's arrangement.  Leading dims (batch,
heads) broadcast and become launch-grid dims; weights without leading dims
are shared, not replicated (:mod:`repro_torch.kernels.batching`).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.blockwise import Blocked, gelu, no_tf32
from repro_torch.kernels import _build
from repro_torch.kernels.batching import lead_grid


# The CTA tiles (CM, CN) that csrc/gemm_tile.cuh instantiates (its
# ``dispatch``), each with the relative FFMA rate of its register tile.
CTA_TILES = {
    (128, 128): 1.0, (128, 64): 0.9, (64, 128): 0.9, (64, 64): 0.8,
    (32, 128): 0.8, (32, 64): 0.7, (16, 128): 0.7, (16, 64): 0.6,
}
SMS = 132  # streaming multiprocessors of an H100 SXM


@functools.lru_cache(maxsize=1024)
def gemm_plan(rows: int, cols: int, bm: int, bn: int, lead: int = 1) -> Tuple[int, int]:
    """The CTA tile (CM, CN) for a ``rows x cols`` output in ``lead`` slots
    whose data blocks are ``bm x bn``: among the tiles that span whole
    blocks, the one with the least modelled time -- waves of CTAs over the
    card's SMs times one CTA's work over its tile's FFMA rate -- and the
    largest of equals.  A skinny or narrow product so gets a short or
    narrow tile, a large one the largest tile that still fills the card."""
    def cost(tile):
        cm, cn = tile
        ctas = math.ceil(rows / cm) * math.ceil(cols / cn) * lead
        return math.ceil(ctas / SMS) * cm * cn / CTA_TILES[tile], -cm * cn

    fits = [t for t in CTA_TILES if t[0] % bm == 0 and t[1] % bn == 0]
    if not fits:
        raise ValueError(f"no CTA tile spans whole {bm} x {bn} blocks")
    return min(fits, key=cost)


@no_tf32()
def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same loop over the k-blocks
    into an fp32 accumulator, then (with ``bias``) the bias + tanh-GELU
    epilogue.  ``(..., gm, gk, bm, bk) @ (..., gk, gn, bk, bn)``."""
    a, b = a.float(), b.float()
    acc = None
    for kb in range(a.shape[-3]):
        # (..., gm, 1, bm, bk) @ (..., 1, gn, bk, bn) -> (..., gm, gn, bm, bn)
        t = torch.matmul(a[..., kb, :, :].unsqueeze(-3), b[..., kb, :, :, :].unsqueeze(-4))
        acc = t if acc is None else acc + t
    if bias is not None:
        acc = gelu(acc + bias.float()[:, None, :])
    return acc


def check_gemm(kernel: str, a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor]):
    """Check the operands the kernel takes, on either device; return
    ``((gm, gn, gk, bm, bn, bk), lead grid)``."""
    if a.dim() < 4 or b.dim() < 4:
        raise ValueError(f"{kernel}: blocked operands need 4 trailing dims, "
                         f"got {tuple(a.shape)} @ {tuple(b.shape)}")
    gm, gk, bm, bk = a.shape[-4:]
    gk2, gn, bk2, bn = b.shape[-4:]
    if (gk, bk) != (gk2, bk2):
        raise ValueError(f"{kernel}: inner blocks mismatch: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    operands = (a, b) if bias is None else (a, b, bias)
    _build.check_operands(kernel, *operands)
    _build.check_block(kernel, bm, bn, bk)
    if bias is not None and tuple(bias.shape) != (gn, bn):
        raise ValueError(f"{kernel}: bias must be blocked ({gn}, {bn}), "
                         f"got {tuple(bias.shape)}")
    grid = lead_grid((a, b), (4, 4))
    if gm > 65535 or grid.size > 65535:
        raise ValueError(f"{kernel}: grid too large (gm={gm}, lead={grid.shape})")
    return (gm, gn, gk, bm, bn, bk), grid


def launch_gemm(kernel: str, a: torch.Tensor, b: torch.Tensor,
                bias: Optional[torch.Tensor], tile: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
    """Launch ``csrc/bwma_gemm.cu`` (the fused variant when ``bias`` is given)
    on CUDA tensors with the CTA tile of :func:`gemm_plan` (or ``tile``);
    returns the fp32 output.  Does not synchronise.

    bf16 operands are widened to fp32 on the device first and run the fp32
    kernel: a product of two bf16 values is exact in fp32, so this is what
    an fp32-accumulating bf16 kernel computes, at the cost of the copies."""
    (gm, gn, gk, bm, bn, bk), grid = check_gemm(kernel, a, b, bias)
    a, b, bias = _build.as_fp32(a, b, bias)
    cm, cn = tile or gemm_plan(gm * bm, gn * bn, bm, bn, grid.size)
    out = torch.empty(*grid.shape, gm, gn, bm, bn, dtype=torch.float32, device=a.device)
    (sa0, sa1), (sb0, sb1) = grid.strides
    lib = _build.library()
    with torch.cuda.device(a.device):
        if bias is None:
            pa, pb, po = _build.launch_args(a, b, out)
            code = lib.bwma_gemm_f32(
                pa, pb, po, *grid.dims, sa0, sa1, sb0, sb1,
                gm, gn, gk, bm, bn, bk, cm, cn, _build.stream(a.device))
        else:
            pa, pb, pc, po = _build.launch_args(a, b, bias, out)
            code = lib.bwma_fused_ffn_f32(
                pa, pb, pc, po, *grid.dims, sa0, sa1, sb0, sb1,
                gm, gn, gk, bm, bn, bk, cm, cn, _build.stream(a.device))
    _build.check(code, kernel)
    return out


def bwma_gemm(a_blocked, b_blocked):
    """(..., gm, gk, bm, bk) @ (..., gk, gn, bk, bn) -> (..., gm, gn, bm, bn).

    Accepts raw blocked tensors or :class:`Blocked` wrappers (the result
    type follows the inputs).  Operands are fp32 or bf16, summed in fp32: a
    raw result is the fp32 accumulator, a :class:`Blocked` one is cast back
    to the input dtype, as in the JAX package.  CUDA tensors launch the
    kernel; CPU tensors take :func:`gemm_plain`.
    """
    wrapped = isinstance(a_blocked, Blocked)
    if wrapped != isinstance(b_blocked, Blocked):
        raise TypeError("pass both operands as Blocked or both as raw blocked arrays")
    a, b = a_blocked, b_blocked
    if wrapped:
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
        a, b = a_blocked.data, b_blocked.data
    a, b = _build.operands(a, b, aligned=True)
    if _build.on_cuda("bwma_gemm", a, b):
        out = launch_gemm("bwma_gemm", a, b, None)
        bwma_gemm.launches += 1
    else:
        check_gemm("bwma_gemm", a, b, None)
        out = gemm_plain(a, b)
    if wrapped:
        return Blocked(out.to(a_blocked.dtype), (a_blocked.shape[0], b_blocked.shape[1]),
                       a_blocked.layout)
    return out


bwma_gemm.launches = 0
