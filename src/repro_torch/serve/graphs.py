"""The continuous engine's decode step, captured once as a CUDA graph.

Counterpart of the JAX engine's compiled decode step (``jax.jit`` of
``_paged_step`` with the pool donated, in ``repro.serve.engine``): one
dispatch a step, the pool written in place.  :class:`DecodeGraph` owns a
static device buffer for each input of the step -- the tokens, the
positions, the page table and the active mask -- and copies each step's
values into them (host arrays from pinned memory, asynchronously: no sync),
then replays the graph.  Its outputs, the greedy tokens and the logits, are
the graph's static outputs: the next replay overwrites them, so a caller
that keeps a step's tokens copies them out first.

**Warm-up and capture.**  At construction the runner calls the step on a
side stream with every slot inactive and the whole page table on the null
page: inactive writes land only on the null page, and the SSM and ring rows
of inactive slots keep their bits, so the pool's live contents survive.
The warm-up builds the kernel library and initialises cuBLAS; then the step
is captured once into a ``torch.cuda.CUDAGraph`` with a private memory
pool.  A capture that fails raises: nothing falls back to the eager step on
the card, so a sync or a data-dependent shape inside the step surfaces as
an error.  On the CPU the same runner keeps the same buffers and copies
around an eager call of the step, chosen by the device alone.

**What a capture binds.**  One engine's weights, pool and the paged
kernels' workspaces (:func:`repro_torch.kernels.paged_attention.own_workspaces`:
the runner owns the partials it captured, so a later, larger eager call
cannot free them).  Each engine builds its own runner, and the graph and its
memory go with it; nothing is memoized per config.

**Launch counters.**  The wrappers count in Python where they launch, so
the warm-up counts what it ran and the capture counts what it recorded
without running it.  Both are taken back off the counters (kept as the
runner's ``warmup_launches`` and ``replay_launches``), and each replay adds
``replay_launches``: the counters read what the card ran for the steps.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch import kernels as K
from repro_torch import tree as T
from repro_torch.kernels.paged_attention import own_workspaces
from repro_torch.serve.kvcache import upload_into

#: eager calls on the side stream before the capture
WARMUP_STEPS = 2


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    now = K.launch_counts()
    return {k: n - before[k] for k, n in now.items() if n != before[k]}


class DecodeGraph:
    """The decode step ``step(params, pool, tokens, seq_pos, page_table,
    active) -> (greedy, logits, pool)`` of one engine, on static buffers:
    captured as a CUDA graph on a CUDA ``device``, called eagerly on the
    CPU.  Call it as the step; it returns ``(greedy, logits, pool)``, the
    first two its static outputs and ``pool`` the caller's tree, whose
    leaves must be those it was built with, written in place.
    ``max_seqs`` and ``max_pages`` size the buffers."""

    def __init__(self, step: Callable, params, pool, max_seqs: int, max_pages: int,
                 device):
        self.step, self.params, self.pool = step, params, pool
        self._pool_leaves = T.leaves(pool)
        self.device = torch.device(device)
        i32 = {"dtype": torch.int32, "device": self.device}
        self.tokens = torch.zeros((max_seqs, 1), **i32)
        self.seq_pos = torch.zeros((max_seqs,), **i32)
        self.table = torch.zeros((max_seqs, max_pages), **i32)  # the null page
        self.active = torch.zeros((max_seqs,), dtype=torch.bool, device=self.device)
        self.graph = None
        self.captures = 0
        self.calls = 0
        self.warmup_launches: Dict[str, int] = {}
        self.replay_launches: Dict[str, int] = {}
        self.capture_seconds = 0.0
        self.pool_bytes = 0  # what the capture reserved: the graph's private pool
        self._workspaces: dict = {}
        self.greedy, self.logits = self._build()

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    def _eager(self) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad(), own_workspaces(self._workspaces):
            greedy, logits, _ = self.step(self.params, self.pool, self.tokens,
                                          self.seq_pos, self.table, self.active)
        return greedy, logits

    def _build(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Warm up, then capture on the card; the static outputs.  The
        counters end as they began."""
        before = K.launch_counts()
        if not self.graphed:
            out = self._eager()  # its outputs become the static ones
            self.warmup_launches = _launches_since(before)
            K.add_launches({k: -n for k, n in self.warmup_launches.items()})
            return out
        self._warm_up()
        self.warmup_launches = _launches_since(before)
        warm = K.launch_counts()
        out = self._record()
        self.captures += 1
        self.replay_launches = _launches_since(warm)
        K.add_launches({k: before[k] - n for k, n in K.launch_counts().items()})
        return out

    def _warm_up(self) -> None:
        """The eager steps on a side stream (the kernel build, cuBLAS)."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._eager()
        main.wait_stream(side)

    def _record(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Capture the step into :attr:`graph`; its static outputs."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = self._eager()
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        return out

    def _replay(self) -> None:
        self.graph.replay()

    def __call__(self, params, pool, tokens, seq_pos, page_table, active):
        """One step: ``tokens`` (max_seqs, 1) and ``page_table`` tensors,
        ``seq_pos`` and ``active`` host arrays or tensors, copied into the
        static buffers; ``params`` and ``pool`` must be the runner's own."""
        leaves = T.leaves(pool)
        if params is not self.params or len(leaves) != len(self._pool_leaves) or any(
                a is not b for a, b in zip(leaves, self._pool_leaves)):
            raise ValueError("DecodeGraph: the step is bound to the weights and the pool "
                             "it was built with")
        self.tokens.copy_(tokens)
        upload_into(self.seq_pos, seq_pos)
        self.table.copy_(page_table)
        upload_into(self.active, active)
        if self.graphed:
            self._replay()
            K.add_launches(self.replay_launches)
        else:
            greedy, logits = self._eager()
            self.greedy.copy_(greedy)
            self.logits.copy_(logits)
        self.calls += 1
        return self.greedy, self.logits, pool
