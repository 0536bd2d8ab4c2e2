"""BWMA port to PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A second package beside the JAX reference ``repro``, with the same module
paths and public names: ``core`` holds the layout, blockwise operators,
backends and the blocked encoder; ``kernels`` the CUDA kernels, each with a
plain PyTorch version of the same function beside it.  The package imports
``torch``, numpy and the standard library, never ``jax`` or ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a kernel wrapper takes its plain version only for tensors
that lie on the CPU, and launches its kernel (or raises) for CUDA tensors.
"""
