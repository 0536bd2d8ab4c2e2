"""Model zoo: configs' layers, caches and forward passes.

Counterpart of ``repro.models``: ``common`` (norms, RoPE, attention math,
``dense``), ``attention`` (GQA, MLA and cross-attention, their static and
block-paged caches), ``ffn`` (dense feed-forward and MoE), ``ssm`` (the
Mamba-2 SSD block), ``adapters`` (the paged-cache registry) and ``model``
(assembly, parameters, prefill and decode steps).
"""
