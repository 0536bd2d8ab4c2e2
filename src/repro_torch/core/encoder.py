"""End-to-end blocked transformer encoder -- the paper's case study (BERT-base).

Counterpart of ``repro.core.encoder``.  With BWMA the *entire* encoder stack
runs on block-wise data; RWMA<->BWMA conversion happens once at the input
and once at the output (paper §3.2).

* ``encoder_rwma`` -- conventional row-major PyTorch (the paper's baseline),
* ``encoder_bwma`` -- everything blocked, dispatched through a
  :class:`~repro_torch.core.backend.Backend`: ``"cuda"`` (the default, the
  hand-written kernels) or ``"reference"`` (the plain blockwise operators).

Entry points run on the CUDA device unless the caller asks for the CPU:
:func:`init_params`, :func:`params_from_numpy` and :func:`block_params`
place their tensors on ``device``, which defaults to ``"cuda"`` and raises
when CUDA is absent.  :func:`encoder_bwma` runs where its tensors live.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import torch

from repro_torch.core import blockwise as bw
from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.layout import BlockLayout, to_blockwise


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """BERT-style encoder. Paper defaults: BERT-base, seq 512."""

    seq_len: int = 512
    d_model: int = 768
    n_heads: int = 12
    d_head: int = 64
    d_ff: int = 3072
    n_layers: int = 12
    block: int = 16  # kernel block size (paper: 8/16)
    dtype: torch.dtype = torch.float32

    @property
    def layout(self) -> BlockLayout:
        return BlockLayout(self.block, self.block)


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when none is given; raise without CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def init_layer_params(cfg: EncoderConfig, generator: torch.Generator,
                      device=None) -> Dict[str, torch.Tensor]:
    """One encoder layer's parameters, row-major (canonical storage).

    Drawn from ``generator`` on its own device, then moved to ``device``.
    The numbers differ from the JAX package's for the same seed; parity
    tests carry the JAX weights across with :func:`params_from_numpy`.
    """
    device = resolve_device(device)
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    s = 0.02

    def normal(*shape):
        x = torch.randn(shape, generator=generator, dtype=cfg.dtype,
                        device=generator.device)
        return (x * s).to(device)

    def const(value, n):
        return torch.full((n,), value, dtype=cfg.dtype, device=device)

    return {
        "wq": normal(h, d, dh),
        "wk": normal(h, d, dh),
        "wv": normal(h, d, dh),
        "wo": normal(h * dh, d),
        "w1": normal(d, f),
        "b1": const(0.0, f),
        "w2": normal(f, d),
        "b2": const(0.0, d),
        "ln1_g": const(1.0, d),
        "ln1_b": const(0.0, d),
        "ln2_g": const(1.0, d),
        "ln2_b": const(0.0, d),
    }


def init_params(cfg: EncoderConfig, generator: Optional[torch.Generator] = None,
                device=None) -> List[Dict[str, torch.Tensor]]:
    """All layers' parameters on ``device`` (default CUDA; raises without it).

    ``generator`` defaults to a CPU generator seeded with 0, so the weights
    do not depend on the device they end up on.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device="cpu").manual_seed(0)
    return [init_layer_params(cfg, generator, device) for _ in range(cfg.n_layers)]


def params_from_numpy(params, device=None) -> List[Dict[str, torch.Tensor]]:
    """The JAX package's ``init_params`` output, as numpy arrays (the same
    list of dicts, keys and shapes), carried over to tensors on ``device``."""
    device = resolve_device(device)
    return [
        {name: torch.tensor(x, device=device) for name, x in p.items()}
        for p in params
    ]


# --------------------------------------------------------------------------
# RWMA baseline (row-major, conventional)
# --------------------------------------------------------------------------

def _layernorm(x, g, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def encoder_layer_rwma(p, x, cfg: EncoderConfig):
    h = []
    scale = 1.0 / float(cfg.d_head) ** 0.5
    for i in range(cfg.n_heads):
        q = x @ p["wq"][i]
        k = x @ p["wk"][i]
        v = x @ p["wv"][i]
        a = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
        h.append(a @ v)
    att = torch.cat(h, dim=-1) @ p["wo"]
    x = _layernorm(x + att, p["ln1_g"], p["ln1_b"])
    ff = bw.gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return _layernorm(x + ff, p["ln2_g"], p["ln2_b"])


@bw.no_tf32()
def encoder_rwma(params, x, cfg: EncoderConfig):
    for p in params:
        x = encoder_layer_rwma(p, x, cfg)
    return x


# --------------------------------------------------------------------------
# BWMA path -- everything blocked end-to-end
# --------------------------------------------------------------------------

def block_layer_params(p, cfg: EncoderConfig, device=None):
    """Pre-arrange one layer's weights block-wise (done once, offline), on
    ``device`` (default CUDA; raises without it)."""
    device = resolve_device(device)
    p = {name: x.to(device) for name, x in p.items()}
    lo = cfg.layout
    h, dh, d = cfg.n_heads, cfg.d_head, cfg.d_model
    out = {}
    for name in ("wq", "wk", "wv"):
        out[name] = to_blockwise(p[name], lo)  # (h, gm, gn, bm, bn)
    # wo is blocked PER HEAD along its row (h*dh) axis: each head's dh rows
    # are padded to a block multiple independently, so they line up with the
    # per-head padded columns that merge_heads stacks (interior zeros cancel
    # in the GEMM).
    wo = to_blockwise(p["wo"].reshape(h, dh, d), lo)  # (h, gdh, gd, b, b)
    out["wo"] = wo.reshape(h * wo.shape[1], *wo.shape[2:])
    for name in ("w1", "w2"):
        out[name] = to_blockwise(p[name], lo)
    for name in ("b1", "b2", "ln1_g", "ln1_b", "ln2_g", "ln2_b"):
        out[name] = bw.block_vector(p[name], lo).contiguous()
    return out


def block_params(params, cfg: EncoderConfig, device=None):
    return [block_layer_params(p, cfg, device) for p in params]


def encoder_layer_bwma(
    pb,
    xb: bw.Blocked,
    cfg: EncoderConfig,
    backend: Union[str, Backend, None] = None,
) -> bw.Blocked:
    lo = cfg.layout
    d, dh, f = cfg.d_model, cfg.d_head, cfg.d_ff
    be = resolve_backend(backend)
    scale = 1.0 / float(dh) ** 0.5
    # All heads at once: weights keep their (h, ...) leading dim and the
    # input gains a broadcasting head axis, so each op below is ONE kernel
    # launch over every (batch, head) slot.
    xh = bw.add_head_axis(xb)
    q = be.matmul(xh, bw.Blocked(pb["wq"], (d, dh), lo))  # (..., h, gs, gd, b, b)
    k = be.matmul(xh, bw.Blocked(pb["wk"], (d, dh), lo))
    v = be.matmul(xh, bw.Blocked(pb["wv"], (d, dh), lo))
    # Fused scores -> softmax -> @V: intermediates never leave BWMA order.
    ctx = be.attention(q, k, v, scale=scale)
    att_all = bw.merge_heads(ctx)  # (..., gs, h*gd, b, b)
    proj = be.matmul(att_all, bw.Blocked(pb["wo"], (att_all.shape[1], d), lo))
    x1 = be.layernorm(be.add(xb, proj), pb["ln1_g"], pb["ln1_b"])
    # Feed-forward up-projection: GEMM + bias + GELU fused at write-back.
    act = be.ffn(x1, bw.Blocked(pb["w1"], (d, f), lo), pb["b1"])
    down = be.bias(be.matmul(act, bw.Blocked(pb["w2"], (f, d), lo)), pb["b2"])
    return be.layernorm(be.add(x1, down), pb["ln2_g"], pb["ln2_b"])


def encoder_bwma(
    blocked_params,
    x: torch.Tensor,
    cfg: EncoderConfig,
    backend: Union[str, Backend, None] = "cuda",
    *,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Full encoder: RWMA->BWMA once, N blocked layers, BWMA->RWMA once.

    ``backend`` selects the execution path (``"cuda"`` | ``"reference"`` | a
    :class:`Backend` instance).  It runs on the device ``x`` and the
    parameters live on.  ``x`` may carry leading batch dims:
    ``(..., seq_len, d_model)``.  ``interpret`` exists only to reject the
    JAX package's Pallas option with a clear error.
    """
    be = resolve_backend(backend, interpret=interpret)
    xb = bw.block(x, cfg.layout)  # the only input-side conversion
    for pb in blocked_params:
        xb = encoder_layer_bwma(pb, xb, cfg, be)
    return xb.unblock()  # the only output-side conversion


def bert_base_config(block: int = 16, n_layers: int = 12) -> EncoderConfig:
    """The paper's evaluation model (§4.1): BERT-base, 512x768 input."""
    return EncoderConfig(
        seq_len=512, d_model=768, n_heads=12, d_head=64, d_ff=3072,
        n_layers=n_layers, block=block,
    )
