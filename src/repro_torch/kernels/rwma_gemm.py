"""RWMA tiled GEMM, the paper's baseline arrangement: the CUDA kernel
``csrc/rwma_gemm.cu`` and its plain version.

Counterpart of ``repro.kernels.rwma_gemm``.  Operands are conventional
row-major 2-D tensors.  The tiling (bm, bk, bn) is the blocked GEMM's
(:mod:`repro_torch.kernels.bwma_gemm`, the same CUDA loop); only the
storage order differs: each tile the kernel loads is ``bm`` row segments at
a stride of K elements instead of one contiguous run.  Functionally the two
are the same product, which is the point: the layout is a pure
memory-system optimisation.
"""
from __future__ import annotations

import torch

from repro_torch.core.blockwise import no_tf32
from repro_torch.kernels import _build


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


@no_tf32()
def rwma_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 128,
               bn: int = 128) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same loop over the k-tiles
    into an fp32 accumulator, on row-major operands."""
    check_rwma(a, b, bm, bk, bn)
    acc = None
    for k0 in range(0, a.shape[1], bk):
        t = torch.matmul(a[:, k0:k0 + bk], b[k0:k0 + bk])
        acc = t if acc is None else acc + t
    return acc


def rwma_gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 128,
              bn: int = 128) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) f32 with row-major (strided) operand tiles.

    Every shape must be a multiple of its tile, as in the JAX kernel, which
    also takes any such tile; the operands are contiguous fp32.  CUDA
    tensors launch ``csrc/rwma_gemm.cu`` (the blocked GEMM's loop for tiles
    of 8..128, powers of two, and a general-tile kernel for the rest); CPU
    tensors take :func:`rwma_plain`.
    """
    if not _build.on_cuda("rwma_gemm", a, b):
        return rwma_plain(a, b, bm=bm, bk=bk, bn=bn)
    gm, gn, gk = check_rwma(a, b, bm, bk, bn)
    out = torch.empty(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        pa, pb, po = _build.launch_args(a, b, out)
        code = _build.library().rwma_gemm_f32(pa, pb, po, gm, gn, gk, bm, bn, bk,
                                              _build.stream(a.device))
    _build.check(code, "rwma_gemm")
    rwma_gemm.launches += 1
    return out


rwma_gemm.launches = 0
