"""Assigned input shapes -> meta-device stand-ins for the dry run.

Counterpart of ``repro.configs.shapes``.  Every (arch × shape) cell is
described by ``input_specs(cfg, shape)``: tensors on the ``meta`` device,
which carry a shape and a dtype and allocate nothing.  ``applicable``
encodes the assignment's skip rules (long_500k only for sub-quadratic
archs).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig

META = torch.device("meta")


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runnable?, reason-if-not) for an (arch, shape) cell."""
    SHAPES[shape_name]  # validate the shape name (KeyError on a typo)
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (see DESIGN.md)"
        )
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_spec(b: int, s: int) -> torch.Tensor:
    return _spec((b, s), torch.int32)


def _frontend_extras(cfg: ModelConfig, b: int, s: int) -> Dict:
    out = {}
    if cfg.frontend == "vision":
        nv = min(cfg.n_frontend_tokens, s)
        out["vis_embeds"] = _spec((b, nv, cfg.d_model), cfg.dtype)
        out["positions3"] = _spec((3, b, s), torch.int32)
    if cfg.frontend == "audio":
        out["audio_embeds"] = _spec((b, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The decode cache tree on the meta device (zero allocation)."""
    from repro_torch.models import model as M

    return M.init_cache(cfg, batch, max_len, device=META)


def input_specs(cfg: ModelConfig, shape_name: str, rows: Optional[int] = None) -> Dict:
    """Returns {kind, specs} where specs matches the step function's args;
    ``rows`` in place of the shape's global batch (a cell cut to fit one
    device)."""
    shape = SHAPES[shape_name]
    b, s = rows or shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": _token_spec(b, s), "labels": _token_spec(b, s)}
        batch.update(_frontend_extras(cfg, b, s))
        return {"kind": "train", "batch": batch}
    if shape.kind == "prefill":
        batch = {"tokens": _token_spec(b, s)}
        batch.update(_frontend_extras(cfg, b, s))
        return {"kind": "prefill", "batch": batch}
    # decode: one new token against a cache of length s
    return {
        "kind": "decode",
        "tokens": _token_spec(b, 1),
        "pos": _spec((), torch.int32),
        "caches": cache_specs(cfg, b, s),
    }
