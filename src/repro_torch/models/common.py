"""Shared building blocks: norms, RoPE, chunked attention math, and ``dense``.

Counterpart of ``repro.models.common``.  ``apply_mrope`` (the vision
frontend's M-RoPE) waits for the vision slice (ROADMAP.md queue 1 item 24).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

MASK = torch.finfo(torch.float32).min


def norm_apply(cfg: ModelConfig, w, x, b=None, eps: float = 1e-5):
    """RMSNorm or LayerNorm, computed in fp32 and cast back to ``x.dtype``."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        y = y * w.float()
    else:
        mean = torch.mean(xf, -1, keepdim=True)
        var = torch.mean((xf - mean) ** 2, -1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps) * w.float()
        if b is not None:
            y = y + b.float()
    return y.to(x.dtype)


def norm_init(cfg: ModelConfig, d: int, device=None):
    if cfg.norm == "rmsnorm":
        return {"w": torch.ones((d,), dtype=cfg.dtype, device=device)}
    return {"w": torch.ones((d,), dtype=cfg.dtype, device=device),
            "b": torch.zeros((d,), dtype=cfg.dtype, device=device)}


def apply_norm(cfg: ModelConfig, p, x):
    return norm_apply(cfg, p["w"], x, p.get("b"))


def activation(cfg: ModelConfig, x):
    """SiLU, or GELU in its tanh form (``jax.nn.gelu``'s default)."""
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, device=None):
    """A (d_in, d_out) weight drawn N(0, scale^2) in fp32 from ``generator``
    on its own device, then cast to ``dtype`` and moved to ``device``."""
    s = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(s).to(device=device, dtype=dtype)


def _kernel_tile(blk: int) -> int:
    """The largest tile the CUDA GEMMs take (8..128, powers of two) that is
    not above ``blk``."""
    from repro_torch.kernels._build import SUPPORTED_BLOCKS

    return max(b for b in SUPPORTED_BLOCKS if b <= blk)


def dense(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Linear layer with a selectable memory arrangement (the paper's
    technique as a first-class switch):

    * ``xla``  -- plain ``x @ w`` (the JAX package leaves this product to
      XLA, outside any kernel);
    * ``bwma`` -- the blocked GEMM kernel through the ``"cuda"`` backend:
      weights and activations are stored as contiguous kernel-sized blocks
      (paper Fig. 4d);
    * ``rwma`` -- the row-major tiled GEMM kernel (the paper's baseline).

    The kernel routes take fp32 or bf16 (summed in fp32) and return
    ``x.dtype``, as in the JAX package.  The tile is the JAX package's: ``cfg.block``, clipped to the
    operand sizes, at least 8.  ``rwma`` runs its kernel at that tile
    whenever it divides the shapes and falls back to ``x2 @ w`` only where
    it does not, as in the JAX package; ``bwma`` pads its blocks, so it runs
    at the largest tile its kernel takes (8..128, powers of two) not above
    the JAX one.
    """
    if cfg.gemm_backend == "xla" or w.dim() != 2:
        return x @ w
    from repro_torch.core import blockwise as bw
    from repro_torch.core.backend import resolve_backend
    from repro_torch.core.layout import BlockLayout
    from repro_torch.kernels import ops as kops

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    blk = min(cfg.block, *x2.shape, *w.shape)
    blk = max(8, blk)
    if cfg.gemm_backend == "bwma":
        layout = BlockLayout(_kernel_tile(blk), _kernel_tile(blk))
        out = resolve_backend("cuda").matmul(
            bw.block(x2, layout), bw.block(w, layout)
        ).unblock()
    else:  # rwma
        m, k = x2.shape
        n = w.shape[1]
        if m % blk or k % blk or n % blk:
            out = x2 @ w  # the row-major kernel needs dividing shapes
        else:
            out = kops.matmul_rwma(x2, w.contiguous(), bm=blk, bk=blk, bn=blk)
    return out.to(x.dtype).reshape(*lead, w.shape[1])


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """(dim//2,) inverse frequencies."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE.  x: (B, S, H, D); positions: (B, S) integer."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)  # (d/2,)
    ang = positions.float()[..., None] * inv  # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def default_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None].expand(batch, seq)


# --------------------------------------------------------------------------
# Chunked (flash-style) attention, plain PyTorch
# --------------------------------------------------------------------------

def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, Dq)
    k: torch.Tensor,  # (B, Sk, Hkv, Dq)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    q_offset=0,  # absolute position of q[0] (host int)
    k_positions: Optional[torch.Tensor] = None,  # (B, Sk) absolute key positions
    window: Optional[int] = None,  # SWA: keys with q_pos - k_pos >= window masked
    q_chunk: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Memory-bounded attention: a loop over query chunks, full K/V per chunk.

    Scores are fp32 (the operands are upcast, which is what the JAX
    package's bf16 product with an fp32 result computes), the probabilities
    cast to ``v.dtype`` before ``@ v``.  GQA folds query heads onto their kv
    head (``(Hkv, group)``), so no K/V repetition is materialised.
    """
    B, Sq, H, Dq = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    g = H // Hkv
    scale = scale if scale is not None else Dq ** -0.5
    if k_positions is None:
        k_positions = torch.arange(Sk, dtype=torch.int32, device=q.device)[None].expand(B, Sk)
    kp = k_positions.long()[:, None, None, None, :]  # (B,1,1,1,Sk)
    kf = k.float()
    qc = min(q_chunk, Sq)
    if Sq % qc:
        qc = Sq  # a single chunk for awkward sizes
    outs = []
    for c in range(Sq // qc):
        qi = q[:, c * qc:(c + 1) * qc].reshape(B, qc, Hkv, g, Dq).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kf) * scale
        q_pos = q_offset + c * qc + torch.arange(qc, device=q.device)
        qp = q_pos[None, None, None, :, None]
        # kp >= 0 masks empty cache entries (labelled -1)
        mask = (kp >= 0).expand(B, 1, 1, qc, Sk)
        if causal:
            mask = mask & (kp <= qp)
        if window is not None:
            mask = mask & (qp - kp < window)
        s = torch.where(mask, s, MASK)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, v))  # (B, qc, Hkv, g, Dv)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, Dv)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dq)
    k_cache: torch.Tensor,  # (B, Sc, Hkv, Dq)
    v_cache: torch.Tensor,  # (B, Sc, Hkv, Dv)
    k_positions: torch.Tensor,  # (B, Sc) absolute positions; -1 = empty slot
    q_pos,  # absolute position of the new token: int or (B,) per slot
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention over a (possibly ring-buffer) cache."""
    B, Sc, Hkv, Dq = k_cache.shape
    H = q.shape[2]
    g = H // Hkv
    Dv = v_cache.shape[-1]
    scale = scale if scale is not None else Dq ** -0.5
    qi = q.reshape(B, Hkv, g, Dq).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qi, k_cache.float()) * scale
    if not isinstance(q_pos, torch.Tensor):
        q_pos = torch.tensor(q_pos, device=q.device)
    if q_pos.dim() == 0:  # one shared position (static-wave decode)
        q_pos = q_pos.expand(B)
    qp = q_pos.long()[:, None]  # (B, 1) per-slot positions (continuous batching)
    kpos = k_positions.long()
    valid = (kpos >= 0) & (kpos <= qp)
    if window is not None:
        valid = valid & (qp - kpos < window)
    s = torch.where(valid[:, None, None, :], s, MASK)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache)
    return out.reshape(B, 1, H, Dv)
