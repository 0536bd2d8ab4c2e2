"""Build, load and launch the package's CUDA kernels (no JAX counterpart).

The sources under ``csrc/`` have a plain C interface.  At first use they are
compiled for Hopper with ``nvcc`` -- one process per source, all started
together -- and linked into one shared library under ``build/<hash>/``
beside this module, keyed by a hash of the sources and flags, then loaded
with :mod:`ctypes`.  Pointers and the stream pass as ``c_void_p``.  Every
entry point returns ``cudaGetLastError()`` after its launch and
:func:`check` raises when that is not 0: a refused launch never runs, and a
later synchronise would not report it.

Nothing here falls back: no ``nvcc``, a failed build or a failed launch
raises.  The CPU path of each wrapper is taken only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).with_name("build")
LIB_NAME = "libbwma_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
SUPPORTED_BLOCKS = (8, 16, 32, 64, 128)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # a, b, out, lead0, lead1, a_s0, a_s1, b_s0, b_s1, gm, gn, gk, bm, bn, bk, cm, cn,
    # stream
    "bwma_gemm_f32": ([_P, _P, _P] + [_I] * 2 + [_L] * 4 + [_I] * 8 + [_P], _I),
    # a, b, bias, out, then as bwma_gemm_f32
    "bwma_fused_ffn_f32": ([_P] * 4 + [_I] * 2 + [_L] * 4 + [_I] * 8 + [_P], _I),
    # x, gamma, beta, out, x_bf16, gamma_bf16, beta_bf16, lead0, lead1, x_s0, x_s1, gm, gn,
    # bm, bn, n_logical, eps, vectors_per_lane, stream
    "bwma_layernorm": ([_P] * 4 + [_I] * 5 + [_L] * 2 + [_I] * 5 + [_F, _I, _P], _I),
    # q, k, v, out, lead0, lead1, 6 strides, gs, gd, bm, bd, padded width, bq, bkv,
    # s_logical, scale, stream
    "bwma_attention_f32": ([_P] * 4 + [_I] * 2 + [_L] * 6 + [_I] * 8 + [_F, _P], _I),
    # padded width, bq, bkv
    "bwma_attention_smem_bytes": ([_I] * 3, _L),
    # a, b, out, M, N, K, cm, cn, stream
    "rwma_gemm_f32": ([_P] * 3 + [_I] * 5 + [_P], _I),
    # a, b, out, gm, gn, gk, bm, bn, bk, stream
    "rwma_any_tile_f32": ([_P] * 3 + [_I] * 6 + [_P], _I),
    # q, k_pages, v_pages, table, seq_pos, out, workspace, B, H, hkv, dh, page, maxp,
    # splits, scale, stream
    "paged_attention_decode_f32": ([_P] * 7 + [_I] * 7 + [_F, _P], _I),
    "paged_attention_decode_bf16": ([_P] * 7 + [_I] * 7 + [_F, _P], _I),
    # q_lat, q_rope, ckv_pages, krope_pages, table, seq_pos, out, workspace, B, H, r, dr,
    # page, maxp, splits, scale, stream
    "mla_paged_attention_decode_f32": ([_P] * 8 + [_I] * 7 + [_F, _P], _I),
    "mla_paged_attention_decode_bf16": ([_P] * 8 + [_I] * 7 + [_F, _P], _I),
    # pool, layers, layer_bytes, page_bytes, src, dst, stream
    "paged_copy": ([_P, _I, _L, _L, _I, _I, _P], _I),
    # x, out, block_rows, gn, bm, bn, n_logical, vectors_per_lane, stream
    "bwma_softmax_f32": ([_P, _P, _L] + [_I] * 5 + [_P], _I),
    "bwma_softmax_bf16": ([_P, _P, _L] + [_I] * 5 + [_P], _I),
    # x, out, elem_size, word, blocks, gm, gn, bm, bn, tile_blocks, tile_rows, tile_cols,
    # stream
    "bwma_transpose": ([_P, _P, _I, _I, _L] + [_I] * 7 + [_P], _I),
    "bwma_error_string": ([_I], ctypes.c_char_p),
}


def sources() -> list:
    """The translation units: every ``csrc/*.cu`` (headers are included)."""
    return sorted(CSRC.glob("*.cu"))


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):  # sources and their headers
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _run_all(cmds: Sequence[Sequence[str]], what: Sequence[str]) -> None:
    """Run ``cmds`` in parallel; raise with the compiler output of any failure."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failures = []
        for p, name in zip(procs, what):
            out, _ = p.communicate()
            if p.returncode:
                failures.append(f"{name} (exit {p.returncode}):\n{out}")
        if failures:
            raise RuntimeError("nvcc failed on " + "\n".join(failures))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library, once per source hash."""
    key = _source_key()
    lib = BUILD_ROOT / key / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"{key}.", dir=BUILD_ROOT))
    try:
        srcs = sources()
        objs = [tmp / f"{s.stem}.o" for s in srcs]
        _run_all(
            [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(srcs, objs)],
            [s.name for s in srcs],
        )
        _run_all(
            [[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp / LIB_NAME)]],
            ["link"],
        )
        try:
            tmp.rename(lib.parent)
        except OSError:  # another process finished the same build first
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code:
        msg = library().bwma_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")


def refuse_autograd(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when grad mode is on and an operand requires a gradient: a
    kernel launched through ``ctypes`` returns a tensor with no
    ``grad_fn``, so its operands would silently get no gradient (and the
    plain version on the CPU would differentiate where the card cannot)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: the hand-written kernels have no backward; "
                           "differentiate through gemm_backend='xla', or run under "
                           "torch.no_grad()")


def on_cuda(kernel: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raise on a mix or on any other device, and (every wrapper asks
    here before it runs) on an operand that autograd would track
    (:func:`refuse_autograd`)."""
    refuse_autograd(kernel, *tensors)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    raise ValueError(f"{kernel}: operands must all be on one CUDA device or all "
                     f"on the CPU, got {sorted(map(str, devices))}")


# the types the GEMM, LayerNorm and attention wrappers take: the LayerNorm
# kernel reads bf16 itself, the GEMMs and the attention widen it on the device
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def as_fp32(*tensors: Optional[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """The operands as fp32: bf16 ones widened on their device, fp32 ones
    (and ``None``) passed through with no call."""
    return [t if t is None or t.dtype == torch.float32 else t.float() for t in tensors]


def check_operands(kernel: str, *tensors: torch.Tensor) -> None:
    """The kernels take fp32 or bf16 tensors; raise on anything else."""
    for t in tensors:
        if t.dtype not in KERNEL_DTYPES:
            raise TypeError(f"{kernel}: the kernels take fp32 or bf16, got {t.dtype}")


# copies :func:`operands` made, apart from the kernels' launch counts
operand_copies = 0


def operands(*tensors: Optional[torch.Tensor], aligned: bool = False) -> list:
    """Each operand as it is where the kernel can read it in place --
    contiguous and, with ``aligned`` (the kernels whose pointers go through
    :func:`launch_args`), at a 16-byte address on the card -- else a fresh
    contiguous copy, one per operand, counted in :data:`operand_copies`.
    ``None`` passes through.  So the wrappers take any view, as the
    reference does, and the kernel still runs, on the copy."""
    global operand_copies
    out = []
    for t in tensors:
        if t is None or (t.is_contiguous() and not (aligned and t.is_cuda and t.data_ptr() % 16)):
            out.append(t)
        else:
            out.append(t.clone(memory_format=torch.contiguous_format))
            operand_copies += 1
    return out


def check_block(kernel: str, *dims: int) -> None:
    for d in dims:
        if d not in SUPPORTED_BLOCKS:
            raise ValueError(f"{kernel}: block dim {d} not in {SUPPORTED_BLOCKS}")


def launch_args(*tensors: torch.Tensor) -> list:
    """Device pointers of ``tensors``, after checking that each is
    contiguous at the 16-byte alignment the kernels' vector loads need (the
    wrappers pass their operands through :func:`operands` first)."""
    ptrs = []
    for t in tensors:
        ptr = t.data_ptr()
        if ptr % 16 or not t.is_contiguous():
            raise ValueError(f"operand of shape {tuple(t.shape)} is not contiguous at a "
                             "16-byte aligned address")
        ptrs.append(ptr)
    return ptrs


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
