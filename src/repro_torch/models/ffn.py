"""Feed-forward modules, dense part: SwiGLU and the GELU MLP.

Counterpart of the dense half of ``repro.models.ffn``; the token-choice
top-k MoE waits for the MoE slice (ROADMAP.md queue 1 item 19).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense, dense_init


def ffn_init(generator: torch.Generator, cfg: ModelConfig, d_ff: int = 0,
             device=None) -> Dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu":  # SwiGLU: gate + up + down
        return {
            "w_gate": dense_init(generator, d, f, cfg.dtype, device=device),
            "w_up": dense_init(generator, d, f, cfg.dtype, device=device),
            "w_down": dense_init(generator, f, d, cfg.dtype, device=device),
        }
    return {  # GELU MLP (whisper / bert style)
        "w_up": dense_init(generator, d, f, cfg.dtype, device=device),
        "b_up": torch.zeros((f,), dtype=cfg.dtype, device=device),
        "w_down": dense_init(generator, f, d, cfg.dtype, device=device),
        "b_down": torch.zeros((d,), dtype=cfg.dtype, device=device),
    }


def ffn_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:
        gate = F.silu(dense(cfg, x, p["w_gate"]))
        return dense(cfg, gate * dense(cfg, x, p["w_up"]), p["w_down"])
    # GELU in its tanh form, jax.nn.gelu's default
    h = F.gelu(dense(cfg, x, p["w_up"]) + p["b_up"], approximate="tanh")
    return dense(cfg, h, p["w_down"]) + p["b_down"]
