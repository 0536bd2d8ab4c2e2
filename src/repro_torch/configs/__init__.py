"""Architecture registry: ``--arch <id>`` resolves through here.

Counterpart of ``repro.configs``, with the same ten architectures, their
full and smoke configurations, and :func:`get_config`.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (
    deepseek_v3_671b,
    granite_moe_3b,
    h2o_danube3_4b,
    hymba_1_5b,
    mamba2_130m,
    minicpm_2b,
    qwen15_110b,
    qwen2_vl_72b,
    starcoder2_7b,
    whisper_tiny,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES = [
    qwen2_vl_72b,
    granite_moe_3b,
    deepseek_v3_671b,
    mamba2_130m,
    qwen15_110b,
    starcoder2_7b,
    minicpm_2b,
    h2o_danube3_4b,
    hymba_1_5b,
    whisper_tiny,
]

ARCHS: Dict[str, object] = {m.ARCH_ID: m for m in _MODULES}


def arch_ids() -> List[str]:
    return list(ARCHS.keys())


def get_config(arch: str, *, smoke: bool = False, **overrides) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[arch].smoke_config() if smoke else ARCHS[arch].full_config()
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "arch_ids",
    "get_config",
]
