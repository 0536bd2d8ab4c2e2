"""AdamW, functional, with fp32 moments over (possibly bf16) parameters.

Counterpart of ``repro.optim.adamw``.  It works on tensors under
``torch.no_grad()``, not through ``torch.optim``: the state tree (``m``,
``v``, ``step``), the step counter and the order of operations are the JAX
package's, so the two agree step for step on the same gradients.  The
bias correction uses the incremented step, weight decay reaches every
leaf, and the update runs in fp32 whatever the parameters' type, the
moments kept in ``OptConfig.moment_dtype``.

On a mesh each rank holds shards of the parameters, gradients and moments:
the update stays element-wise on the rank's shards, and the global norm
that clips the gradients is the sum of squares over every shard
(``reduce_sumsq``, :meth:`repro_torch.distributed.sharding.TrainLayout.
global_sumsq`: summed over the axes each leaf is split on, a replicated
leaf counted once).

``adamw_update(..., donate=True)`` writes the new parameters and moments
into the tensors it was given (the JAX package donates them to its jitted
step) and needs no second copy of the state; without it the arguments are
left as they were and new trees come back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # fp32 moments by default; bf16 halves the optimizer's memory
    moment_dtype: Any = torch.float32


def adamw_init(params, oc: "OptConfig" = None) -> Dict[str, Any]:
    """Zero moments beside each parameter and a zero int32 step, on the
    parameters' device."""
    dt = oc.moment_dtype if oc is not None else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "m": T.tree_map(zeros, params),
        "v": T.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=T.leaves(params)[0].device),
    }


SumsqReducer = Callable[[List[torch.Tensor]], torch.Tensor]


@torch.no_grad()
def global_norm(tree, reduce_sumsq: Optional[SumsqReducer] = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares; on
    shards, ``reduce_sumsq`` turns the leaves' local sums (flatten order)
    into the global sum."""
    sq = [torch.sum(torch.square(x.float())) for x in T.leaves(tree)]
    return torch.sqrt(sum(sq) if reduce_sumsq is None else reduce_sumsq(sq))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # max_norm / norm as one fp32 division, as JAX computes it (a Python
    # float over a tensor would multiply by the reciprocal: two roundings)
    return torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(the gradients in fp32, scaled so that their global norm is at most
    ``max_norm``; the norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return T.tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(grads, opt_state, params, oc: OptConfig, lr_now, *,
                 donate: bool = False, reduce_sumsq: Optional[SumsqReducer] = None
                 ) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step.  ``grads`` may be bf16 and ``lr_now`` a Python float
    or a 0-d tensor; the math runs in fp32.  Each leaf's gradient is
    clipped as it is used (:func:`clip_by_global_norm`'s values, without
    an fp32 copy of the whole gradient tree), by the global norm
    (:func:`global_norm` with ``reduce_sumsq`` on shards)."""
    scale = _clip_scale(global_norm(grads, reduce_sumsq), oc.grad_clip)
    step = opt_state["step"] + 1
    t = step.float()
    bc1 = 1.0 - oc.b1 ** t
    bc2 = 1.0 - oc.b2 ** t
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(T.leaves(params), T.leaves(grads), T.leaves(opt_state["m"]),
                          T.leaves(opt_state["v"])):
        g = g.float() * scale
        m_new = oc.b1 * m.float() + (1 - oc.b1) * g
        v_new = oc.b2 * v.float() + (1 - oc.b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + oc.eps) + oc.weight_decay * p.float()
        p_new = (p.float() - lr_now * delta).to(p.dtype)
        if donate:
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
            continue
        new_p.append(p_new)
        new_m.append(m_new.to(oc.moment_dtype))
        new_v.append(v_new.to(oc.moment_dtype))
    if donate:
        opt_state["step"].copy_(step)
        return params, opt_state
    return T.unflatten(params, new_p), {"m": T.unflatten(params, new_m),
                                         "v": T.unflatten(params, new_v), "step": step}
