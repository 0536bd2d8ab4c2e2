"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each wrapper carries a ``launches`` counter that it increments where it
launches its kernel and nowhere else; :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0 and :func:`add_launches` adds to
them.
"""
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
from repro_torch.kernels.rwma_gemm import rwma_gemm

KERNELS = (bwma_gemm, bwma_fused_ffn, bwma_layernorm, bwma_attention,
           rwma_gemm, paged_attention_decode, paged_copy,
           mla_paged_attention_decode, bwma_softmax, bwma_transpose)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def add_launches(counts: dict) -> None:
    """Add ``counts`` ({name: n}, n may be negative) to the counters: a CUDA
    graph's replay launches what its capture counted without launching."""
    for k in KERNELS:
        k.launches += counts.get(k.__name__, 0)
