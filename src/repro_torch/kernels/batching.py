"""Leading-dim (batch / head) support for the CUDA BWMA kernels.

Counterpart of ``repro.kernels.batching``.  There is no ``vmap``: each kernel
is written for one blocked matrix per launch-grid slot, and the broadcast
leading dims of its operands become launch-grid dims.  :func:`lead_grid`
broadcasts the leading shapes (numpy rules), pads them to two dims, and gives
each operand its own element stride along each of the two, **0 where the
operand broadcasts**.  An operand is therefore never copied along an axis it
broadcasts over: the Q/K/V projection reads an activation of lead ``(B, 1)``
against per-head weights of lead ``(h,)``, and the ``wo``/``w1``/``w2``
weights, which have no lead dims at all, are read once per block by every
slot.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

MAX_LEAD_DIMS = 2


@dataclasses.dataclass(frozen=True)
class LeadGrid:
    """The broadcast leading dims of one kernel call.

    ``shape`` is the broadcast lead shape the output carries; ``dims`` the
    same padded on the left to two dims (the launch grid's lead axes);
    ``strides[i]`` operand ``i``'s element strides along those two dims.
    """

    shape: Tuple[int, ...]
    dims: Tuple[int, int]
    strides: Tuple[Tuple[int, int], ...]

    @property
    def size(self) -> int:
        return self.dims[0] * self.dims[1]


def lead_grid(args: Sequence[torch.Tensor], core_ndims: Sequence[int]) -> LeadGrid:
    """Broadcast the leading dims of ``args`` beyond their core ranks.

    Raises on more than two broadcast lead dims, on lead shapes that do not
    broadcast, and on operands that are not contiguous (their strides would
    not describe blocked storage).
    """
    if len(args) != len(core_ndims):
        raise ValueError(f"{len(args)} args vs {len(core_ndims)} core ranks")
    leads = [tuple(a.shape[: a.dim() - c]) for a, c in zip(args, core_ndims)]
    # equal lead shapes (one operand, or q/k/v of one attention) broadcast to
    # themselves; torch.broadcast_shapes costs tens of µs of the launch path
    lead = leads[0] if leads.count(leads[0]) == len(leads) else tuple(
        torch.broadcast_shapes(*leads))
    n = len(lead)
    if n > MAX_LEAD_DIMS:
        raise ValueError(
            f"at most {MAX_LEAD_DIMS} leading (batch, head) dims are supported, "
            f"got lead shape {lead}"
        )
    strides = []
    for a, ld in zip(args, leads):
        if not a.is_contiguous():
            raise ValueError(f"operand of shape {tuple(a.shape)} is not contiguous")
        pad = n - len(ld)
        sizes = (1,) * pad + ld
        st = (0,) * pad + tuple(a.stride()[: len(ld)])
        mine = tuple(0 if s == 1 else x for s, x in zip(sizes, st))
        strides.append((0,) * (MAX_LEAD_DIMS - n) + mine)
    dims = (1,) * (MAX_LEAD_DIMS - n) + lead
    return LeadGrid(lead, dims, tuple(strides))
