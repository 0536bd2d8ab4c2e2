"""RWMA tiled GEMM, the paper's baseline arrangement: the CUDA kernel
``csrc/rwma_gemm.cu`` and its plain version.

Counterpart of ``repro.kernels.rwma_gemm``.  Operands are conventional
row-major 2-D tensors.  At equal tiling (bm, bk, bn) it runs the blocked
GEMM's CUDA loop with the same CTA tile
(:func:`repro_torch.kernels.bwma_gemm.gemm_plan`); only the storage order
differs: each k-slice the kernel loads is row segments at a stride of K
elements instead of contiguous block rows.  Functionally the two are the
same product, which is the point: the layout is a pure memory-system
optimisation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.blockwise import no_tf32
from repro_torch.kernels import _build
from repro_torch.kernels.bwma_gemm import gemm_plan


def check_rwma(a: torch.Tensor, b: torch.Tensor, bm: int, bk: int, bn: int):
    """Check the operands on either device (the JAX kernel's errors first);
    return (gm, gn, gk)."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"rwma_gemm: operands must be 2-D, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if min(bm, bk, bn) < 1:
        raise ValueError(f"rwma_gemm: tiles must be positive, got {(bm, bk, bn)}")
    if M % bm or K % bk or N % bn:
        raise ValueError(f"shapes {tuple(a.shape)}x{tuple(b.shape)} not divisible by blocks")
    _build.check_operands("rwma_gemm", a, b)
    if M // bm > 65535:
        raise ValueError(f"rwma_gemm: grid too large (M // bm = {M // bm})")
    return M // bm, N // bn, K // bk


def rwma_route(M: int, K: int, N: int, bm: int, bn: int):
    """Which CUDA kernel takes a checked product, and its CTA tile.

    ``("tile_loop", (cm, cn))``: the shared GEMM loop, when K and N are
    multiples of 4 (its 16-byte chunks); the plan is the blocked GEMM's at
    the same tiling for blocks of 8..128 (powers of two), else one over
    single rows and columns, since row-major addressing does not depend on
    the tile.  ``("any_tile", None)``: the general-tile kernel, for the
    rest (tile 9 over 45 columns)."""
    if K % 4 or N % 4:
        return "any_tile", None
    if bm in _build.SUPPORTED_BLOCKS and bn in _build.SUPPORTED_BLOCKS:
        return "tile_loop", gemm_plan(M, N, bm, bn)
    return "tile_loop", gemm_plan(M, N, 1, 1)


@no_tf32()
def rwma_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 128,
               bn: int = 128) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same loop over the k-tiles
    into an fp32 accumulator, on row-major operands (bf16 widened first)."""
    check_rwma(a, b, bm, bk, bn)
    a, b = a.float(), b.float()
    acc = None
    for k0 in range(0, a.shape[1], bk):
        t = torch.matmul(a[:, k0:k0 + bk], b[k0:k0 + bk])
        acc = t if acc is None else acc + t
    return acc


def launch_rwma(a: torch.Tensor, b: torch.Tensor, bm: int, bk: int, bn: int,
                tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Launch ``csrc/rwma_gemm.cu`` on CUDA tensors on the route of
    :func:`rwma_route` (``tile`` overrides the plan's CTA tile on the shared
    loop); returns the fp32 output.  Does not synchronise.  bf16 operands
    are widened to fp32 on the device first, as in
    :func:`repro_torch.kernels.bwma_gemm.launch_gemm`."""
    gm, gn, gk = check_rwma(a, b, bm, bk, bn)
    a, b = _build.as_fp32(a, b)
    (M, K), N = a.shape, b.shape[1]
    route, plan = rwma_route(M, K, N, bm, bn)
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        pa, pb, po = _build.launch_args(a, b, out)
        lib, stream = _build.library(), _build.stream(a.device)
        if route == "tile_loop":
            code = lib.rwma_gemm_f32(pa, pb, po, M, N, K, *(tile or plan), stream)
        else:
            code = lib.rwma_any_tile_f32(pa, pb, po, gm, gn, gk, bm, bn, bk, stream)
    _build.check(code, "rwma_gemm")
    return out


def rwma_gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 128,
              bn: int = 128) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) f32 with row-major (strided) operand tiles.

    Every shape must be a multiple of its tile, as in the JAX kernel, which
    also takes any such tile; the operands are fp32 or bf16 (a view, or an
    operand off a 16-byte address, runs on a contiguous copy), and
    the result is fp32 either way (the JAX kernel's ``acc_dtype``).  CUDA
    tensors launch ``csrc/rwma_gemm.cu`` (the blocked GEMM's loop, or the
    general-tile kernel where K or N is not a multiple of 4:
    :func:`rwma_route`); CPU tensors take :func:`rwma_plain`.
    """
    a, b = _build.operands(a, b, aligned=True)
    if not _build.on_cuda("rwma_gemm", a, b):
        return rwma_plain(a, b, bm=bm, bk=bk, bn=bn)
    out = launch_rwma(a, b, bm, bk, bn)
    rwma_gemm.launches += 1
    return out


rwma_gemm.launches = 0
