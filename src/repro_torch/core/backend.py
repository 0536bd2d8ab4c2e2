"""Selectable execution backends for the blocked (BWMA) encoder.

Counterpart of ``repro.core.backend``.  :class:`Backend` is the set of
compute operators the encoder needs, all closed over
:class:`~repro_torch.core.blockwise.Blocked` values, with two
implementations in this package's own registry:

* ``"cuda"`` -- the hand-written CUDA kernels of :mod:`repro_torch.kernels`:
  blocked GEMM, the fused GEMM + bias + GELU feed-forward, blocked
  LayerNorm and the fused streaming attention.  Each wrapper launches its
  kernel for CUDA tensors and takes its plain version for CPU tensors.
  This is the default: ``None`` resolves to ``"cuda"``.
* ``"reference"`` -- the plain blockwise operators of
  :mod:`repro_torch.core.blockwise`, the oracle path.

Layout-neutral element-wise ops (add, bias, scale, map) are plain PyTorch
in both, as in the JAX package.  ``interpret=`` has no counterpart here: no
backend takes it, and passing it raises.
"""
from __future__ import annotations

from typing import Callable, Dict, Protocol, Union, runtime_checkable

from repro_torch.core import blockwise as bw
from repro_torch.core.blockwise import Blocked
from repro_torch.kernels.bwma_attention import bwma_attention
from repro_torch.kernels.bwma_fused_ffn import bwma_fused_ffn
from repro_torch.kernels.bwma_gemm import bwma_gemm
from repro_torch.kernels.bwma_layernorm import bwma_layernorm


@runtime_checkable
class Backend(Protocol):
    """The operator set the blocked encoder dispatches through.

    All matrix arguments/results are :class:`Blocked`; blocked vectors
    (bias, gamma, beta) are raw ``(gn, bn)`` tensors as produced by
    :func:`repro_torch.core.blockwise.block_vector`.  Implementations must
    accept leading batch/head dims on the data operands.
    """

    name: str

    def matmul(self, a: Blocked, b: Blocked) -> Blocked: ...

    def softmax(self, a: Blocked) -> Blocked: ...

    def layernorm(self, a: Blocked, gamma_b, beta_b) -> Blocked: ...

    def ffn(self, a: Blocked, w: Blocked, bias_b) -> Blocked: ...

    def attention(self, q: Blocked, k: Blocked, v: Blocked, *, scale) -> Blocked: ...

    def transpose(self, a: Blocked) -> Blocked: ...

    def paged_attention_decode(self, q, k_pages, v_pages, page_table, seq_pos): ...

    def mla_paged_attention_decode(self, q_lat, q_rope, ckv_pages, krope_pages,
                                   page_table, seq_pos, *, scale): ...

    def paged_copy_page(self, pools: Dict, src, dst) -> Dict: ...

    def add(self, a: Blocked, b: Blocked) -> Blocked: ...

    def bias(self, a: Blocked, bias_b) -> Blocked: ...

    def scale(self, a: Blocked, s) -> Blocked: ...

    def map(self, a: Blocked, fn: Callable) -> Blocked: ...


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


class _ElementwiseMixin:
    """The arrangement-independent ops, shared by every backend."""

    def add(self, a: Blocked, b: Blocked) -> Blocked:
        return bw.bw_add(a, b)

    def bias(self, a: Blocked, bias_b) -> Blocked:
        return bw.bw_bias(a, bias_b)

    def scale(self, a: Blocked, s) -> Blocked:
        return bw.bw_scale(a, s)

    def map(self, a: Blocked, fn: Callable) -> Blocked:
        return bw.bw_map(a, fn)

    # The serving engine's paged-decode operators belong to the serving
    # slice: the gather oracles (models/attention.py) and their kernels.
    def paged_attention_decode(self, q, k_pages, v_pages, page_table, seq_pos):
        _not_ported(f"{self.name} paged_attention_decode",
                    "queue 1 item 10, queue 2 item 6")

    def mla_paged_attention_decode(self, q_lat, q_rope, ckv_pages, krope_pages,
                                   page_table, seq_pos, *, scale):
        _not_ported(f"{self.name} mla_paged_attention_decode",
                    "queue 1 item 18, queue 2 item 8")

    def paged_copy_page(self, pools: Dict, src, dst) -> Dict:
        _not_ported(f"{self.name} paged_copy_page", "queue 1 item 10, queue 2 item 7")


class ReferenceBackend(_ElementwiseMixin):
    """Plain PyTorch blockwise semantics (the oracle path)."""

    name = "reference"

    def matmul(self, a: Blocked, b: Blocked) -> Blocked:
        return bw.bw_matmul(a, b)

    def softmax(self, a: Blocked) -> Blocked:
        return bw.bw_softmax(a)

    def layernorm(self, a: Blocked, gamma_b, beta_b) -> Blocked:
        return bw.bw_layernorm(a, gamma_b, beta_b)

    def ffn(self, a: Blocked, w: Blocked, bias_b) -> Blocked:
        return bw.bw_map(bw.bw_bias(bw.bw_matmul(a, w), bias_b), bw.gelu)

    def attention(self, q: Blocked, k: Blocked, v: Blocked, *, scale) -> Blocked:
        return bw.bw_attention(q, k, v, scale=scale)

    def transpose(self, a: Blocked) -> Blocked:
        return bw.bw_transpose(a)


class CudaBackend(_ElementwiseMixin):
    """The hand-written CUDA BWMA kernels -- the execution path the paper
    describes.  Operators whose kernels are not ported yet raise."""

    name = "cuda"

    def matmul(self, a: Blocked, b: Blocked) -> Blocked:
        return bwma_gemm(a, b)

    def softmax(self, a: Blocked) -> Blocked:
        _not_ported("cuda softmax (bwma_softmax kernel)", "queue 2 item 9")

    def layernorm(self, a: Blocked, gamma_b, beta_b) -> Blocked:
        return bwma_layernorm(a, gamma_b, beta_b)

    def ffn(self, a: Blocked, w: Blocked, bias_b) -> Blocked:
        return bwma_fused_ffn(a, w, bias_b)

    def attention(self, q: Blocked, k: Blocked, v: Blocked, *, scale) -> Blocked:
        return bwma_attention(q, k, v, scale=scale)

    def transpose(self, a: Blocked) -> Blocked:
        _not_ported("cuda transpose (bwma_transpose kernel)", "queue 2 item 10")


BACKENDS: Dict[str, Callable[[], Backend]] = {
    "reference": ReferenceBackend,
    "cuda": CudaBackend,
}

DEFAULT_BACKEND = "cuda"

# Named backends are memoized, so every caller shares one instance.
_INSTANCES: Dict[str, Backend] = {}


def resolve_backend(spec: Union[str, Backend, None], *, interpret=None) -> Backend:
    """Turn a backend name / instance / None into a Backend.

    ``None`` means ``"cuda"``, the kernel backend.  ``interpret`` belongs to
    the JAX package's Pallas backend and has no counterpart here, so passing
    it is an error rather than a silent no-op.
    """
    if spec is None:
        spec = DEFAULT_BACKEND
    if isinstance(spec, str):
        if spec not in BACKENDS:
            raise ValueError(f"unknown backend {spec!r}; available: {sorted(BACKENDS)}")
        if interpret is not None:
            raise ValueError(
                f"interpret={interpret!r} only applies to the JAX package's "
                f"'pallas' backend, not {spec!r}"
            )
        if spec not in _INSTANCES:
            _INSTANCES[spec] = BACKENDS[spec]()
        return _INSTANCES[spec]
    if isinstance(spec, Backend):
        if interpret is not None:
            raise ValueError("interpret= cannot override an already-constructed Backend")
        return spec
    raise TypeError(f"backend must be a name or Backend, got {type(spec)}")
