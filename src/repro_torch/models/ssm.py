"""Mamba-2 (SSD -- state-space duality) block, plain PyTorch.

Counterpart of ``repro.models.ssm``.  The chunked SSD algorithm: within a
chunk the recurrence is the dual *quadratic* form (batched products over
the chunk), across chunks a linear scan carries the (H, P, N) state.  A
naive step-by-step recurrence (:func:`ssm_reference`) is the test oracle,
and its step (:func:`ssm_step`) is the decode step.

Element types follow the JAX package: ``A_log``, ``D``, ``dt_bias`` and the
carried ``state`` are fp32 whatever ``cfg.dtype`` is; ``conv_w``,
``conv_b``, ``gn_w``, the projections and the ``conv`` history rows are in
``cfg.dtype``.  No kernel runs here: the JAX package's SSD products are
plain XLA einsums, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, head width, groups, state width)."""
    return cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state


def ssm_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> Dict:
    d = cfg.d_model
    d_in, H, P, G, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * G * N
    in_proj = dense_init(generator, d, 2 * d_in + 2 * G * N + H, cfg.dtype, device=device)
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=generator, dtype=torch.float32,
                         device=device if generator is None else generator.device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.mul_(0.1).to(device=device, dtype=cfg.dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "gn_w": torch.ones((d_in,), dtype=cfg.dtype, device=device),
        "out_proj": dense_init(generator, d_in, d, cfg.dtype, device=device),
    }


def ssm_state_init(cfg: ModelConfig, batch: int, device=None) -> Dict:
    d_in, H, P, G, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * G * N
    return {
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=cfg.dtype,
                            device=device),
    }


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d via shifted adds, summed in fp32 over
    ``i = 0..K-1`` in that order.  xBC: (B, S, C); w: (K, C)."""
    K = w.shape[0]
    if history is not None:
        xpad = torch.cat([history, xBC], dim=1)  # (B, K-1+S, C)
    else:
        xpad = F.pad(xBC, (0, 0, K - 1, 0))
    S = xBC.shape[1]
    acc = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(K):
        acc = acc + xpad[:, i:i + S].float() * w[i].float()
    return F.silu(acc + b.float()).to(xBC.dtype)


def _split_proj(p, cfg: ModelConfig, x):
    d_in, H, P, G, N = ssm_dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    dt = zxbcdt[..., 2 * d_in + 2 * G * N:].float()  # (B, S, H)
    return z, xBC, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus has no threshold; torch's returns x itself above 20,
    # where log1p(exp(-x)) < 2.1e-9 is below half an fp32 ulp of x: the
    # same numbers in fp32
    return F.softplus(x, beta=1.0, threshold=20.0)


def _gated_norm(y, z, w, eps: float = 1e-6):
    """Mamba-2 RMSNormGated: rmsnorm(y * silu(z)) * w (its own eps, 1e-6)."""
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt(torch.mean(g * g, -1, keepdim=True) + eps)
    return (g * w.float()).to(y.dtype)


def _ssd_chunks(xs, B_, C_, dA, init, Q: int):
    """SSD over ``nc`` chunks of exactly ``Q`` tokens from ``init`` state.

    xs: (B, S, H, P) *discretized* inputs (already scaled by dt); B_/C_:
    (B, S, G, N); dA: (B, S, H) log-decays; S == nc * Q.  Returns
    (y (B, S, H, P) fp32, final state (B, H, P, N) fp32).  Head h reads
    group h // (H // G).
    """
    B, S, H, P = xs.shape
    G, N = B_.shape[2], B_.shape[3]
    nc = S // Q
    hg = H // G
    xs_c = xs.reshape(B, nc, Q, H, P).float()
    B_c = B_.reshape(B, nc, Q, G, N).float()
    C_c = C_.reshape(B, nc, Q, G, N).float()
    cum = torch.cumsum(dA.reshape(B, nc, Q, H), dim=2)  # (B, nc, Q, H)
    total = cum[:, :, -1]  # (B, nc, H)

    # intra-chunk (quadratic dual form).  L[i, j] = exp(cum_i - cum_j) for
    # j <= i; masked BEFORE the exp: the upper triangle's positive exponents
    # would overflow to inf
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff, -1e30))
    cb = torch.einsum("bcqgn,bckgn->bcqkg", C_c, B_c)  # (B, nc, Q, Q, G)
    scores = torch.repeat_interleave(cb, hg, dim=-1) * L
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xs_c)

    # chunk-final states
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B, nc, Q, H)
    B_heads = torch.repeat_interleave(B_c, hg, dim=3)  # (B, nc, Q, H, N)
    S_local = torch.einsum("bcqhn,bcqhp->bchpn", B_heads * decay_to_end[..., None], xs_c)

    # inter-chunk scan: the state entering each chunk, then the final state
    st = init
    prev = []
    for c in range(nc):
        prev.append(st)
        st = torch.exp(total[:, c])[..., None, None] * st + S_local[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    C_heads = torch.repeat_interleave(C_c, hg, dim=3)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", C_heads * torch.exp(cum)[..., None],
                           prev_states)
    return (y_intra + y_inter).reshape(B, S, H, P), st


def ssm_forward(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    mode: str = "train",
    state: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Chunked SSD forward.  Returns (out, final state if prefill/decode).

    ``state`` (optional) carries {"state", "conv"} from an earlier prefix so
    a prompt can be prefilled in pieces (the serving engine's chunked
    admission); it is read, never written.  Chunking is **grid-aligned**:
    full ``cfg.ssm_chunk`` chunks from the start of the call, then one
    ragged remainder -- so a sequence prefilled in ssm_chunk-aligned pieces
    runs exactly the ops of the one-shot prefill.
    """
    if mode == "decode":
        return ssm_step(p, cfg, x, state)
    B, S, d = x.shape
    d_in, H, P, G, N = ssm_dims(cfg)
    K = cfg.ssm_conv

    z, xBC_raw, dt = _split_proj(p, cfg, x)
    hist = state["conv"] if state is not None else None
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"], history=hist)
    xs = xBC[..., :d_in].reshape(B, S, H, P)
    B_ = xBC[..., d_in:d_in + G * N].reshape(B, S, G, N)
    C_ = xBC[..., d_in + G * N:].reshape(B, S, G, N)
    dt = _softplus(dt + p["dt_bias"])  # (B, S, H) fp32
    a = -torch.exp(p["A_log"])  # (H,) negative
    dA = dt * a  # (B, S, H) log-decay per step
    xs_d = xs * dt[..., None]  # discretized input (fp32)

    st = (state["state"] if state is not None
          else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))

    # grid-aligned chunking: full ssm_chunk-sized chunks + ragged remainder
    Q = min(cfg.ssm_chunk, S)
    S_main = (S // Q) * Q
    ys = []
    if S_main:
        y_main, st = _ssd_chunks(xs_d[:, :S_main], B_[:, :S_main], C_[:, :S_main],
                                 dA[:, :S_main], st, Q)
        ys.append(y_main)
    if S > S_main:
        y_rem, st = _ssd_chunks(xs_d[:, S_main:], B_[:, S_main:], C_[:, S_main:],
                                dA[:, S_main:], st, S - S_main)
        ys.append(y_rem)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = y + p["D"][None, None, :, None] * xs.float()  # skip path
    y = y.reshape(B, S, d_in).to(x.dtype)
    out = _gated_norm(y, z, p["gn_w"]) @ p["out_proj"]

    new_state = None
    if mode == "prefill":
        # conv cache: the last K-1 *pre-conv* features of the whole stream
        # (prefix history + this call), ssm_step's cache contract
        if hist is None:
            hist = torch.zeros((B, K - 1, xBC_raw.shape[-1]), dtype=xBC_raw.dtype,
                               device=x.device)
        conv_hist = torch.cat([hist, xBC_raw], dim=1)[:, -(K - 1):]
        new_state = {"state": st, "conv": conv_hist}
    return out, new_state


def ssm_step(p: Dict, cfg: ModelConfig, x: torch.Tensor, state: Dict
             ) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrence (decode).  x: (B, 1, d).  Returns the output
    and a new state dict; ``state`` is read, never written."""
    B = x.shape[0]
    d_in, H, P, G, N = ssm_dims(cfg)
    hg = H // G
    z, xBC, dt = _split_proj(p, cfg, x)
    conv_in = torch.cat([state["conv"], xBC], dim=1)  # (B, K, C)
    acc = torch.einsum("bkc,kc->bc", conv_in.float(), p["conv_w"].float())
    xBC_t = F.silu(acc + p["conv_b"].float())  # (B, C) fp32
    xs = xBC_t[:, :d_in].reshape(B, H, P)
    B_ = xBC_t[:, d_in:d_in + G * N].reshape(B, G, N)
    C_ = xBC_t[:, d_in + G * N:].reshape(B, G, N)
    dt_t = _softplus(dt[:, 0] + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt_t * a)  # (B, H)
    B_h = torch.repeat_interleave(B_, hg, dim=1)  # (B, H, N)
    C_h = torch.repeat_interleave(C_, hg, dim=1)
    dx = xs * dt_t[..., None]  # (B, H, P)
    new_state = decay[..., None, None] * state["state"] + torch.einsum("bhp,bhn->bhpn", dx, B_h)
    y = torch.einsum("bhpn,bhn->bhp", new_state, C_h)
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, d_in).to(x.dtype)
    out = _gated_norm(y, z, p["gn_w"]) @ p["out_proj"]
    return out, {"state": new_state, "conv": conv_in[:, 1:]}


def ssm_reference(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Naive token-by-token recurrence -- the oracle of the chunked path."""
    B = x.shape[0]
    st = ssm_state_init(cfg, B, device=x.device)
    outs = []
    for t in range(x.shape[1]):
        o, st = ssm_step(p, cfg, x[:, t:t + 1], st)
        outs.append(o)
    return torch.cat(outs, dim=1)
