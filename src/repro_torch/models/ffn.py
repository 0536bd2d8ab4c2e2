"""Feed-forward modules: dense (SwiGLU / GELU) and token-choice top-k MoE.

Counterpart of ``repro.models.ffn``.  The MoE uses the JAX package's
sort-based capacity dispatch (no (T, E, C) one-hot tensor): tokens are
ranked within their chosen expert by a stable argsort + searchsorted, then
gathered into an (E, C, d) buffer.  The router, the dispatch and the expert
products are plain PyTorch, as they are plain XLA ops outside any Pallas
kernel in the JAX package.

Serving on a mesh: a rank holding the column-parallel ``w_gate`` /
``w_up`` and row-parallel ``w_down`` shards computes its share of the hidden
width and the shares are summed over the ranks that split it -- the model
axis, or every rank of a ``D x M`` mesh where the serve layout splits the
width over both (:func:`repro_torch.distributed.axes.psum`).  The MoE's
expert weights are either expert-parallel (a rank holds ``E/M`` or
``E/(D*M)`` whole experts) or, where the experts do not split, sharded
along each expert's hidden width; either way every rank computes the
router and the capacity dispatch on the same rows (the drop pattern is the
single device's), multiplies the slots of the experts it holds, and the
gated outputs are summed over the same ranks.  A product the mesh does not
split (a hidden width it does not divide) runs whole on each rank, with no
sum.

Training on a data axis: each data rank holds its rows of the global batch,
and the MoE computes its share of the single device's dispatch over the
global batch -- one group, the global capacity, each token ranked within
its expert after the tokens of the lower data ranks (whose per-expert
counts one ``all_reduce`` brings) -- and the auxiliary loss from the
global means, as its share (:func:`repro_torch.distributed.axes.data_sum`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import axes as AX
from repro_torch.distributed.axes import check_split, enter, psum, split_place
from repro_torch.models.common import dense, dense_init


# --------------------------------------------------------------------------
# Dense FFN
# --------------------------------------------------------------------------

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


def ffn_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor, d_ff: int = 0) -> torch.Tensor:
    """The FFN of hidden width ``d_ff`` (``cfg.d_ff`` when 0), or a rank's
    share of it, summed over the ranks that split it."""
    f, here = d_ff or cfg.d_ff, p["w_down"].shape[-2]
    x = enter(x, here != f)
    if "w_gate" in p:
        gate = F.silu(dense(cfg, x, p["w_gate"]))
        return psum(dense(cfg, gate * dense(cfg, x, p["w_up"]), p["w_down"]), here, f,
                    "the FFN's hidden width")
    # GELU in its tanh form, jax.nn.gelu's default; the output bias is
    # added once, after the row-parallel sum
    h = F.gelu(dense(cfg, x, p["w_up"]) + p["b_up"], approximate="tanh")
    return psum(dense(cfg, h, p["w_down"]), here, f, "the FFN's hidden width") + p["b_down"]


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _expert_init(generator: torch.Generator, shape, fan_in: int, dtype, device):
    """Stacked expert weights N(0, 1/fan_in), drawn in fp32 one expert at a
    time (the peak is the stack plus one expert's fp32 draw); without a
    generator (the meta device's shapes) the empty stack."""
    w = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0] if generator is not None else 0):
        draw = torch.randn(shape[1:], generator=generator, dtype=torch.float32,
                           device=generator.device)
        w[e].copy_(draw.mul_(fan_in ** -0.5))
    return w


def moe_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> Dict:
    """The JAX package's MoE parameters: an fp32 router whatever
    ``cfg.dtype`` is, experts stacked as ``(E, d, f)`` / ``(E, f, d)``, and
    a dense ``shared`` FFN of width ``moe_d_ff * n_shared_experts``."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(generator, d, E, torch.float32, device=device),
        "w_gate": _expert_init(generator, (E, d, f), d, cfg.dtype, device),
        "w_up": _expert_init(generator, (E, d, f), d, cfg.dtype, device),
        "w_down": _expert_init(generator, (E, f, d), f, cfg.dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(generator, cfg, cfg.moe_d_ff * cfg.n_shared_experts,
                               device=device)
    return p


def _moe_groups(T: int) -> int:
    """Token groups of the capacity dispatch: one.  The JAX package aligns
    them to the data-parallel shards of a mesh; its single device (and the
    port's) dispatches one group, and a data rank of the port computes its
    share of that one group over the global batch, so a mesh trains the
    single device's function."""
    return 1


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert in one group of ``tokens`` tokens, as the JAX
    package computes them: ``int()`` truncates before the round-up to a
    multiple of 8, and never fewer than 8."""
    return max(8, -(-int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) // 8) * 8)


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(a, idx[..., None], axis=1)`` for (G, N, d) rows."""
    return torch.gather(a, 1, idx[..., None].expand(*idx.shape, a.shape[-1]))


def moe_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).

    Token-choice top-k with group-limited capacity, the JAX package's
    dispatch step for step: each group dispatches into an (E, Cg) buffer;
    overflow tokens drop that expert (their other choices and the shared
    experts still apply).  ``aux`` is the Switch-style load-balancing loss
    (serving discards it; training reads it).  The capacity ``Cg`` comes
    from shapes alone, so the dispatch never waits for the device.
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = _moe_groups(T)
    Tg = T // G
    dev = x.device
    xg = x.reshape(G, Tg, d)
    logits = xg.float() @ p["router"].float()  # (G, Tg, E), fp32 router
    probs = torch.softmax(logits, -1)
    gate_vals, idx = torch.topk(probs, k, dim=-1, sorted=True)  # (G, Tg, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balancing auxiliary loss (Switch-style, global) ----
    # on a data axis: the global means (every rank holds as many tokens),
    # and this rank's share of the loss
    me = probs.mean(dim=(0, 1))  # (E,)
    # each expert's share of the routed tokens: F.one_hot's counts, by a
    # scatter (F.one_hot checks the ids against E with a host sync off CUDA)
    ce = torch.zeros(G, Tg, E, device=dev).scatter_add_(
        -1, idx, torch.ones(idx.shape, device=dev)).mean(dim=(0, 1))
    n_data = AX.data_size()
    if n_data > 1:
        me, ce = AX.data_sum(me) / n_data, AX.data_sum(ce) / n_data
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    if n_data > 1:
        aux = aux / n_data

    # ---- per-group capacity dispatch (sort-based, gathers only) ----
    # on a data axis the group is the global batch: the global capacity,
    # and each token ranked after the lower data ranks' tokens of its expert
    here, places = AX.row_split()
    Cg = moe_capacity(Tg * places, cfg)
    n = Tg * k
    flat_e = idx.reshape(G, n)
    lim = torch.full((E,), Cg, dtype=torch.long, device=dev)
    if places > 1:
        counts_by_rank = torch.zeros((places, E), dtype=torch.long, device=dev)
        # the experts' token counts, by a scatter (shapes alone: it also
        # runs on the meta device, where bincount's length is unknown)
        flat = flat_e.reshape(-1)
        counts_by_rank[here] = counts_by_rank.new_zeros(E).scatter_add_(
            0, flat, torch.ones_like(flat))
        below = AX.data_sum(counts_by_rank)[:here].sum(0)
        lim = torch.clamp(lim - below, min=0)
    token_of = torch.arange(Tg, device=dev).repeat_interleave(k)[None].expand(G, n)
    gate_flat = gate_vals.reshape(G, n)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=dev)[None].expand(G, E).contiguous()
    start = torch.searchsorted(sorted_e, experts)  # left side: first slot of each expert
    rank = torch.arange(n, device=dev)[None] - torch.gather(start, 1, sorted_e)
    keep = rank < lim[sorted_e]
    src_tok = torch.gather(token_of, 1, order)  # (G, n)
    x_sorted = _take_rows(xg, src_tok)
    # expert buffer by gather: slot (e, c) reads sorted position start[e] + c
    ec = torch.arange(E * Cg, device=dev)
    e_of, c_of = ec // Cg, ec % Cg
    start_ext = torch.cat([start, torch.full((G, 1), n, dtype=start.dtype, device=dev)], 1)
    pos = start[:, e_of] + c_of[None]  # (G, E*Cg)
    counts = start_ext[:, e_of + 1] - start[:, e_of]
    valid = c_of[None] < torch.minimum(counts, lim[e_of][None])
    xe = _take_rows(x_sorted, torch.clamp(pos, 0, n - 1)) * valid[..., None].to(cfg.dtype)
    xe = xe.reshape(G, E, Cg, d)

    # ---- expert computation (one batched product per weight, over E) ----
    # a rank holding E/M (or E/(D*M)) whole experts (expert parallelism)
    # multiplies their slots only; the other experts' outputs are zeros here
    # and come from their ranks in the sum below
    e_here, f_here = p["w_gate"].shape[0], p["w_gate"].shape[2]
    check_split(f_here, cfg.moe_d_ff, "the experts' hidden width")
    split = e_here != E or f_here != cfg.moe_d_ff
    xe = enter(xe, split)  # the replicated slots enter the rank's experts
    if e_here != E:
        e0 = split_place(e_here, E, "the MoE's experts")[0] * e_here
        xe = xe[:, e0:e0 + e_here]
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    if e_here != E:
        ye = torch.cat([ye.new_zeros((G, e0, Cg, d)), ye,
                        ye.new_zeros((G, E - e0 - e_here, Cg, d))], dim=1)

    # ---- combine back to tokens ----
    ye = ye.reshape(G, E * Cg, d)
    slot = torch.where(keep, sorted_e * Cg + rank, 0)
    y_sorted = _take_rows(ye, slot)  # (G, n, d)
    gate_sorted = enter(torch.gather(gate_flat, 1, order), split)
    # the gate is cast to cfg.dtype before it multiplies, as in the JAX package
    contrib = y_sorted * (gate_sorted * keep)[..., None].to(cfg.dtype)
    # undo the sort: the inverse permutation restores (token, choice) order,
    # so the per-token combine is a reshape and a sum over k, last
    inv_order = torch.argsort(order, dim=1)
    contrib = _take_rows(contrib, inv_order)
    # one of the two is split: the experts, or each expert's hidden width
    out = psum(contrib.reshape(G, Tg, k, d).sum(dim=2), e_here * f_here, E * cfg.moe_d_ff,
               "the MoE's experts")

    if cfg.n_shared_experts:
        out = out + ffn_forward(p["shared"], cfg, xg, cfg.moe_d_ff * cfg.n_shared_experts)
    return out.reshape(B, S, d), aux
