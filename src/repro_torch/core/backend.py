"""Selectable execution backends for the blocked (BWMA) encoder and the
serving engine's paged decode.

Counterpart of ``repro.core.backend``.  :class:`Backend` is the set of
compute operators the encoder needs, all closed over
:class:`~repro_torch.core.blockwise.Blocked` values, plus the paged-decode
operators of the serving engine, with two implementations in this
package's own registry:

* ``"cuda"`` -- the hand-written CUDA kernels of :mod:`repro_torch.kernels`:
  blocked GEMM, blocked softmax, the fused GEMM + bias + GELU feed-forward,
  blocked LayerNorm, the fused streaming attention, blocked transpose, the
  paged one-token GQA and MLA decodes and the paged copy-on-write.  Each
  wrapper launches its kernel for CUDA tensors and takes its plain version
  for CPU tensors.  This is the default: ``None`` resolves to ``"cuda"``.
* ``"reference"`` -- the plain blockwise operators of
  :mod:`repro_torch.core.blockwise`, the gather->attend paged-decode oracles
  and the sliced page copy of :mod:`repro_torch.models.attention`: the
  oracle path.

Layout-neutral element-wise ops (add, bias, scale, map) are plain PyTorch
in both, as in the JAX package.

Tensor-parallel serving needs no dispatch of its own here.  The JAX package
wraps its three paged kernels in ``shard_map`` under a shard policy (a
``pallas_call`` cannot be partitioned by GSPMD); in this port each rank
already holds its local heads, so the kernels simply receive them:
``paged_attention_decode`` H/M query heads over Hkv/M kv heads of the
rank's pool, ``mla_paged_attention_decode`` H/M heads against the whole
latent pools, ``paged_copy`` the rank's pool slice.  Attention is
head-independent and neither decode plan (``decode_plan``,
``mla_decode_plan``) reads a head count -- the key splits are fixed -- so a
rank's output is the head slice of the unsharded kernel's, bit for bit.  ``interpret=`` has no counterpart here: no
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
from repro_torch.kernels.bwma_softmax import bwma_softmax
from repro_torch.kernels.bwma_transpose import bwma_transpose
from repro_torch.kernels.paged_attention import (
    mla_paged_attention_decode,
    paged_attention_decode,
    paged_copy,
)


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

    # -- paged-decode operators: the gather->attend oracles and the sliced
    # page copy.  Lazy imports: models sits above core in the layering, and
    # the reference math lives next to the cache layouts it reads.

    def paged_attention_decode(self, q, k_pages, v_pages, page_table, seq_pos):
        from repro_torch.models import attention as attn

        return attn.paged_gather_attend(q, k_pages, v_pages, page_table, seq_pos)

    def mla_paged_attention_decode(self, q_lat, q_rope, ckv_pages, krope_pages,
                                   page_table, seq_pos, *, scale):
        from repro_torch.models import attention as attn

        return attn.mla_paged_gather_attend(q_lat, q_rope, ckv_pages, krope_pages,
                                            page_table, seq_pos, scale=scale)

    def paged_copy_page(self, pools: Dict, src, dst) -> Dict:
        from repro_torch.models import attention as attn

        return attn.paged_copy_page(pools, src, dst)


class CudaBackend(_ElementwiseMixin):
    """The hand-written CUDA BWMA kernels -- the execution path the paper
    describes."""

    name = "cuda"

    def matmul(self, a: Blocked, b: Blocked) -> Blocked:
        return bwma_gemm(a, b)

    def softmax(self, a: Blocked) -> Blocked:
        return bwma_softmax(a)

    def layernorm(self, a: Blocked, gamma_b, beta_b) -> Blocked:
        return bwma_layernorm(a, gamma_b, beta_b)

    def ffn(self, a: Blocked, w: Blocked, bias_b) -> Blocked:
        return bwma_fused_ffn(a, w, bias_b)

    def attention(self, q: Blocked, k: Blocked, v: Blocked, *, scale) -> Blocked:
        return bwma_attention(q, k, v, scale=scale)

    def transpose(self, a: Blocked) -> Blocked:
        return bwma_transpose(a)

    def paged_attention_decode(self, q, k_pages, v_pages, page_table, seq_pos):
        return paged_attention_decode(q, k_pages, v_pages, page_table, seq_pos)

    def mla_paged_attention_decode(self, q_lat, q_rope, ckv_pages, krope_pages,
                                   page_table, seq_pos, *, scale):
        return mla_paged_attention_decode(q_lat, q_rope, ckv_pages, krope_pages,
                                          page_table, seq_pos, scale=scale)

    def paged_copy_page(self, pools: Dict, src, dst) -> Dict:
        # one paged_copy launch per stacked pool (k_pages and v_pages, or
        # ckv_pages and krope_pages), in place
        return {name: paged_copy(pool, src, dst) for name, pool in pools.items()}


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
