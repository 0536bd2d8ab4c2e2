"""Step functions: train / prefill / decode.

Counterpart of ``repro.launch.steps``.  The train step takes the gradient
with ``torch.autograd.grad`` over the parameter leaves (no ``.grad``
accumulation on the tensors), then runs AdamW.  Where the JAX package jits
its steps, these run eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import axes as AX
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_update


def split_microbatches(batch: Dict, accum: int) -> Dict:
    """(B, ...) -> (accum, B/accum, ...); ``positions3`` (3, B, S) keeps
    its leading 3: (accum, 3, B/accum, S)."""
    out = {}
    for k, v in batch.items():
        if k == "positions3":
            b = v.shape[1] // accum
            out[k] = v.reshape(3, accum, b, *v.shape[2:]).movedim(0, 1)
        else:
            b = v.shape[0] // accum
            out[k] = v.reshape(accum, b, *v.shape[1:])
    return out


def _tracked(params) -> Tuple[Dict, List[Tuple[bool, List[torch.Tensor]]]]:
    """The tree the loss reads, with fresh autograd leaves sharing the
    parameters' storage, and those leaves grouped per parameter in flatten
    order as (stacked, leaves).  A leaf stacked per layer
    (:func:`repro_torch.models.model.is_layer_stack`) becomes a list of its
    layers: autograd then gives each layer its own gradient, where a stack
    indexed per layer would add a zero-filled stack-sized gradient per
    layer (L times the stack's bytes).  Under a training policy, a stack
    whose layer axis is split over the data axis is gathered whole first
    (:func:`repro_torch.distributed.axes.gather_stack`) and tracked as one
    leaf."""
    groups: List[Tuple[bool, List[torch.Tensor]]] = []

    def track(tree, stacked, path):
        if isinstance(tree, dict):
            return {k: track(tree[k], stacked, path + (k,)) for k in sorted(tree)}
        leaf = tree.detach().requires_grad_(True)
        if not stacked:
            groups.append((False, [leaf]))
            return leaf
        whole = AX.gather_stack(path, leaf)
        if whole is not leaf:  # the layers of the gathered stack
            groups.append((False, [leaf]))
            return list(whole.unbind(0))
        parts = [a.detach().requires_grad_(True) for a in tree.unbind(0)]
        groups.append((True, parts))
        return parts

    return ({k: track(params[k], M.is_layer_stack(k), (k,)) for k in sorted(params)},
            groups)


def _grads(loss, groups) -> List[torch.Tensor]:
    """d loss / d each parameter, in flatten order: a stacked parameter's
    layers stacked back, and a zero where the loss reads no element (as
    ``jax.grad`` gives it)."""
    got = iter(torch.autograd.grad(loss, [p for _, parts in groups for p in parts],
                                   allow_unused=True))
    out = []
    for stacked, parts in groups:
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(parts, got)]
        out.append(torch.stack(g) if stacked else g[0])
    return out


def loss_and_grads(cfg: ModelConfig, params, batch: Dict, *, accum_steps: int = 1,
                   remat: bool = True) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
    """(loss, metrics, gradients in the params' flatten order).

    ``accum_steps > 1`` runs the batch as microbatches, one backward pass
    each, summing fp32 gradients divided by ``accum_steps`` (live
    activations shrink by that factor); the loss is the microbatches' mean
    and the metrics the last microbatch's."""
    tracked, groups = _tracked(params)
    if accum_steps == 1:
        loss, metrics = M.loss_fn(cfg, tracked, batch, remat=remat)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _grads(loss, groups))
    micro = split_microbatches(batch, accum_steps)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in T.leaves(params)]
    loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
    for i in range(accum_steps):
        lv, metrics = M.loss_fn(cfg, tracked, {k: v[i] for k, v in micro.items()},
                                remat=remat)
        for a, g in zip(acc, _grads(lv, groups)):
            a.add_(g.float() / accum_steps)
        loss = loss + lv.detach() / accum_steps
    return loss, {k: v.detach() for k, v in metrics.items()}, acc


def make_train_step(cfg: ModelConfig, oc: OptConfig, lr_fn: Callable, *,
                    accum_steps: int = 1):
    """AdamW train step with optional gradient accumulation:
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``, new
    trees (the arguments are left as they were)."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(cfg, params, batch, accum_steps=accum_steps)
        lr_now = lr_fn(opt_state["step"])
        new_params, new_opt = adamw_update(T.unflatten(params, grads), opt_state, params,
                                           oc, lr_now)
        return new_params, new_opt, {"loss": loss, "lr": lr_now, **metrics}

    return train_step


def pick_accum_steps(cfg: ModelConfig, global_batch: int, seq: int, dp_size: int,
                     budget_bytes: float = 4 * 2**30) -> int:
    """Choose accumulation so that the per-device layer-input stack (the
    dominant remat residual: B_loc*S*d*2*L bytes) fits the budget."""
    b_loc = max(1, global_batch // dp_size)
    est = b_loc * seq * cfg.d_model * 2 * cfg.n_layers
    accum = 1
    while est / accum > budget_bytes and accum < global_batch // dp_size:
        accum *= 2
    return min(accum, max(1, global_batch // dp_size))


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, caches, tokens, pos):
        return M.decode_step(cfg, params, caches, tokens, pos)

    return decode_step
