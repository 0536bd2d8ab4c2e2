"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each wrapper carries a ``launches`` counter that it increments where it
launches its kernel and nowhere else; :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0.
"""
from repro_torch.kernels.bwma_attention import bwma_attention
from repro_torch.kernels.bwma_fused_ffn import bwma_fused_ffn
from repro_torch.kernels.bwma_gemm import bwma_gemm
from repro_torch.kernels.bwma_layernorm import bwma_layernorm
from repro_torch.kernels.paged_attention import paged_attention_decode, paged_copy
from repro_torch.kernels.rwma_gemm import rwma_gemm

KERNELS = (bwma_gemm, bwma_fused_ffn, bwma_layernorm, bwma_attention,
           rwma_gemm, paged_attention_decode, paged_copy)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
