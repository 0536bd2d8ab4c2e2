"""Model zoo, dense/GQA part: configs' layers, caches and forward passes.

Counterpart of ``repro.models``: ``common`` (norms, RoPE, attention math,
``dense``), ``attention`` (GQA and its static and block-paged caches),
``ffn`` (dense feed-forward), ``adapters`` (the paged-cache registry) and
``model`` (assembly, parameters, prefill and decode steps).
"""
