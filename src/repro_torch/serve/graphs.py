"""The serving engines' single-card steps, captured as CUDA graphs.

Counterparts of the JAX serving code's compiled steps: the continuous
engine's decode step (``jax.jit`` of ``_paged_step`` with the pool donated)
and chunk step (``_prefill_chunk_fn``), and the static ``Server``'s prefill
and decode (``_prefill_fn``, ``_decode_fn``), in ``repro.serve.engine``.
Each runner owns a static device buffer for each input of its step, copies
each call's values into them (host arrays from pinned memory,
asynchronously: no sync), then replays the graph.  Its outputs are the
graph's static outputs: the next replay overwrites them, so a caller that
keeps them copies them out first.  The integers the JAX package traces as
scalars -- a chunk's slot, offset and last index, a static decode's
position, a padded prefill's last index -- live in 0-dim int32 buffers, so
one capture serves every value, as one jit signature does.

**Warm-up and capture** (:class:`StepGraph`).  The first call on the card
runs the step ``WARMUP_STEPS`` times eagerly on a side stream (the kernel
build, cuBLAS; one stream a device for every runner), then captures it
once into a ``torch.cuda.CUDAGraph`` with Python's cyclic collector held
off, so that no dead runner's graph is torn down inside the capture.  A
capture that fails raises: nothing falls back to the eager step on the
card, so a sync or a data-dependent shape inside the step surfaces as an
error.  On the CPU the same runner keeps the same buffers and copies around
an eager call of the step, chosen by the device alone.

**What a capture binds.**  One engine's (or Server's) weights, its pool or
cache tree, the pool's page-table mirror (one buffer for the pool's life,
read inside the graph) and the paged kernels' workspaces
(:func:`repro_torch.kernels.paged_attention.own_workspaces`: the runner
owns the partials it captured, so a later, larger eager call cannot free
them).  Each engine builds its own runners, and the graphs and their
memory go with it; nothing is memoized per config.

**Launch counters.**  The wrappers count in Python where they launch, so
the warm-up counts what it ran and the capture counts what it recorded
without running it.  Both are taken back off the counters (kept as the
runner's ``warmup_launches`` and ``replay_launches``), and each replay adds
``replay_launches``: the counters read what the card ran for the steps.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch import tree as T
from repro_torch.kernels.paged_attention import own_workspaces
from repro_torch.serve.kvcache import upload_into

#: eager calls on the side stream before the capture
WARMUP_STEPS = 2


_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one warm-up stream of a device: cuBLAS keeps a workspace for
    each stream it runs on, for the process's life."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    now = K.launch_counts()
    return {k: n - before[k] for k, n in now.items() if n != before[k]}


def _check_bound(what: str, params, tree, own_params, own_leaves: List) -> None:
    leaves = T.leaves(tree)
    if params is not own_params or len(leaves) != len(own_leaves) or any(
            a is not b for a, b in zip(leaves, own_leaves)):
        raise ValueError(f"{what}: the step is bound to the weights and the pool "
                         "it was built with")


class StepGraph:
    """One step on static buffers: the warm-up, the capture, the replay and
    the launch-count bookkeeping every runner shares.  A subclass sets its
    buffers and defines :meth:`_step`, the step called on them, returning
    its outputs.  ``mempool``: a ``torch.cuda.graph_pool_handle()`` shared
    with other runners, or None for a private pool."""

    def __init__(self, device, mempool=None):
        self.device = torch.device(device)
        self.graph = None
        self.captures = 0
        self.calls = 0
        self.warmup_launches: Dict[str, int] = {}
        self.replay_launches: Dict[str, int] = {}
        self.capture_seconds = 0.0
        self.pool_bytes = 0  # what the capture reserved in its memory pool
        self._mempool = mempool
        self._workspaces: dict = {}

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    def _step(self):
        raise NotImplementedError

    def _eager(self):
        with torch.no_grad(), own_workspaces(self._workspaces):
            return self._step()

    def _capture(self):
        """Warm up, then capture on the card; the static outputs.  The
        counters end as they began."""
        before = K.launch_counts()
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
        side = _side_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._eager()
        main.wait_stream(side)

    def _record(self):
        """Capture the step into :attr:`graph`; its static outputs."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()  # a collected graph's teardown would invalidate the capture
        try:
            with torch.cuda.graph(self.graph, pool=self._mempool):
                out = self._eager()
        finally:
            if collecting:
                gc.enable()
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        return out

    def _replay(self) -> None:
        self.graph.replay()

    def _replayed(self) -> None:
        """One replay, its launches counted."""
        self._replay()
        K.add_launches(self.replay_launches)


class DecodeGraph(StepGraph):
    """The decode step ``step(params, pool, tokens, seq_pos, page_table,
    active) -> (greedy, logits, pool)`` of one engine, on static buffers:
    captured at construction on a CUDA ``device``, called eagerly on the
    CPU.  Call it as the step; it returns ``(greedy, logits, pool)``, the
    first two its static outputs and ``pool`` the caller's tree, whose
    leaves must be those it was built with, written in place.
    ``max_seqs`` and ``max_pages`` size the buffers.  ``table``: the pool's
    page-table mirror, read in place (the caller passes it as the step's
    ``page_table``); without one the runner keeps its own table on the null
    page and copies each step's into it.

    The warm-up runs every slot inactive: inactive writes land only on the
    null page, the SSM and ring rows of inactive slots keep their bits, and
    the table is only read, so a live pool's contents survive."""

    def __init__(self, step: Callable, params, pool, max_seqs: int, max_pages: int,
                 device, table: Optional[torch.Tensor] = None):
        super().__init__(device)
        self.step, self.params, self.pool = step, params, pool
        self._pool_leaves = T.leaves(pool)
        i32 = {"dtype": torch.int32, "device": self.device}
        self.tokens = torch.zeros((max_seqs, 1), **i32)
        self.seq_pos = torch.zeros((max_seqs,), **i32)
        self.table = torch.zeros((max_seqs, max_pages), **i32) if table is None else table
        self.active = torch.zeros((max_seqs,), dtype=torch.bool, device=self.device)
        self.greedy, self.logits = self._build()

    def _step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        greedy, logits, _ = self.step(self.params, self.pool, self.tokens, self.seq_pos,
                                      self.table, self.active)
        return greedy, logits

    def _build(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The static outputs: captured on the card; on the CPU one eager
        call's, its launches taken back off the counters."""
        if self.graphed:
            return self._capture()
        before = K.launch_counts()
        out = self._eager()
        self.warmup_launches = _launches_since(before)
        K.add_launches({k: -n for k, n in self.warmup_launches.items()})
        return out

    def __call__(self, params, pool, tokens, seq_pos, page_table, active):
        """One step: ``tokens`` (max_seqs, 1) and ``page_table`` tensors,
        ``seq_pos`` and ``active`` host arrays or tensors, copied into the
        static buffers (the table only where it is not the bound mirror);
        ``params`` and ``pool`` must be the runner's own."""
        _check_bound("DecodeGraph", params, pool, self.params, self._pool_leaves)
        self.tokens.copy_(tokens)
        upload_into(self.seq_pos, seq_pos)
        if page_table is not self.table:
            self.table.copy_(page_table)
        upload_into(self.active, active)
        if self.graphed:
            self._replayed()
        else:
            greedy, logits = self._eager()
            self.greedy.copy_(greedy)
            self.logits.copy_(logits)
        self.calls += 1
        return self.greedy, self.logits, pool


class ChunkGraph(StepGraph):
    """The chunk step ``step(params, pool, tokens, slot, q_off, phys_tok,
    off_tok, table_row, last_idx) -> (logits, pool)`` of one engine at one
    chunk length ``n``, on static buffers: the tokens (1, n), the per-token
    write targets (n,), the three scalars, and the slot's table row read
    inside the step from the pool's page-table ``mirror`` (the caller
    refreshes a dirty mirror before each call).  Captured at its first call
    on a CUDA ``device``, called eagerly on the CPU (no warm-up there: the
    CPU makes exactly the eager engine's calls).

    **The warm-up.**  A chunk has no active mask: it writes its slot's ring,
    SSM and cross rows in place, so running it twice is not idempotent.
    The warm-up writes its K/V to the null page (targets all on page 0) and
    the runner saves the slot's rows of every per-slot pool leaf
    (``slot_rows``: (L, max_seqs, ...) leaves, O(window) or O(state) a
    slot) before it and restores them after; the capture runs nothing.
    So the warm-up leaves every pool leaf but the null page as it was.

    **Memory.**  An engine's chunk graphs share one memory pool
    (``mempool``, the engine's), where each shape's private pool would keep
    its own copy of the chunk's temporaries for the engine's life (up to
    ``log2(chunk) + 1`` shapes, or one per final length where shapes are
    exact).  Sharing is sound because every replay's output is used before
    any other replay of the engine: the engine samples the final chunk's
    logits at once (a sync) and reads no other chunk's, and the replays run
    in turn on one stream.  A later capture may give its temporaries or its
    output memory that an earlier graph also writes; nothing reads that
    memory after another replay has written it."""

    def __init__(self, step: Callable, params, pool, mirror: torch.Tensor, n: int, device,
                 slot_rows: Sequence[torch.Tensor] = (), mempool=None):
        super().__init__(device, mempool)
        self.step, self.params, self.pool, self.mirror = step, params, pool, mirror
        self._pool_leaves = T.leaves(pool)
        self._slot_rows = list(slot_rows)
        i32 = {"dtype": torch.int32, "device": self.device}
        self.tokens = torch.zeros((1, n), **i32)
        self.phys_tok = torch.zeros((n,), **i32)
        self.off_tok = torch.zeros((n,), **i32)
        self.scalars = torch.zeros((3,), **i32)  # slot, q_off, last_idx
        self.slot, self.q_off, self.last_idx = self.scalars.unbind()
        self.logits: Optional[torch.Tensor] = None

    def _step(self) -> torch.Tensor:
        row = self.mirror.index_select(0, self.slot.reshape(1))[0]
        logits, _ = self.step(self.params, self.pool, self.tokens, self.slot, self.q_off,
                              self.phys_tok, self.off_tok, row, self.last_idx)
        return logits

    def _capture(self) -> torch.Tensor:
        """The warm-up and capture with the chunk's K/V on the null page,
        the slot's rows saved before them and restored after."""
        self.phys_tok.zero_()
        self.off_tok.zero_()
        idx = self.slot.reshape(1).long()
        saved = [leaf.index_select(1, idx) for leaf in self._slot_rows]
        out = super()._capture()
        for leaf, rows in zip(self._slot_rows, saved):
            leaf.index_copy_(1, idx, rows)
        return out

    def __call__(self, params, pool, tokens, slot: int, q_off: int, phys_tok, off_tok,
                 last_idx: int):
        """One chunk: ``tokens`` (1, n) and the targets ``phys_tok`` /
        ``off_tok`` (n,) host arrays or tensors, the scalars host ints;
        ``params`` and ``pool`` must be the runner's own.  Returns
        ``(logits, pool)``, the logits the runner's static output on the
        card."""
        _check_bound("ChunkGraph", params, pool, self.params, self._pool_leaves)
        upload_into(self.tokens, tokens)
        upload_into(self.scalars, np.array([slot, q_off, last_idx], np.int32))
        if self.graphed and self.graph is None:
            self.logits = self._capture()
        upload_into(self.phys_tok, phys_tok)
        upload_into(self.off_tok, off_tok)
        if self.graphed:
            self._replayed()
            out = self.logits
        else:
            out = self._eager()
        self.calls += 1
        return out, pool


class PrefillGraph(StepGraph):
    """The static ``Server``'s prefill ``step(params, batch, caches,
    last_idx) -> logits`` at one shape, bound to the wave's cache tree
    ``caches``, into whose first slots the step writes the prefill's
    caches: a static buffer per batch entry (the tokens and any frontend
    extras, shapes and dtypes from ``like``) and, for a padded prompt, the
    0-dim ``last_idx``.  Captured at its first call on a CUDA ``device``
    (the prefill reads no state and writes the same slots each call, so
    its warm-up on the real inputs is harmless), called eagerly on the CPU.
    Returns the logits, the graph's static output on the card; the runner
    keeps no cache tree of its own."""

    def __init__(self, step: Callable, params, like: Dict[str, torch.Tensor], caches,
                 padded: bool, device, mempool=None):
        super().__init__(device, mempool)
        self.step, self.params, self.caches = step, params, caches
        self._cache_leaves = T.leaves(caches)
        self.inputs = {k: torch.zeros(v.shape, dtype=v.dtype, device=self.device)
                       for k, v in like.items()}
        self.last_idx = (torch.zeros((), dtype=torch.int32, device=self.device)
                         if padded else None)
        self.logits: Optional[torch.Tensor] = None

    def _step(self) -> torch.Tensor:
        return self.step(self.params, dict(self.inputs), self.caches, self.last_idx)

    def __call__(self, params, batch: Dict[str, torch.Tensor], caches,
                 last_idx: Optional[int] = None) -> torch.Tensor:
        _check_bound("PrefillGraph", params, caches, self.params, self._cache_leaves)
        for k, buf in self.inputs.items():
            buf.copy_(batch[k])
        if self.last_idx is not None:
            upload_into(self.last_idx, np.asarray(last_idx, np.int32))
        self.calls += 1
        if not self.graphed:
            return self._eager()
        if self.graph is None:
            self.logits = self._capture()
        self._replayed()
        return self.logits


class StaticDecodeGraph(StepGraph):
    """The static ``Server``'s decode step ``step(params, caches, tokens,
    pos) -> (logits, caches)`` for one wave batch size, bound to that
    size's cache tree: static buffers for the tokens (B, 1) and the 0-dim
    position.  Captured at construction on a CUDA ``device`` -- on a freshly
    reset tree, since the warm-up writes a cache slot and the SSM state
    rows, which the caller resets after -- and called eagerly on the CPU
    (no call at construction there).  Returns ``(logits, caches)``, the
    logits the graph's static output on the card."""

    def __init__(self, step: Callable, params, caches, batch: int, device, mempool=None):
        super().__init__(device, mempool)
        self.step, self.params, self.caches = step, params, caches
        self._cache_leaves = T.leaves(caches)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32, device=self.device)
        self.pos = torch.zeros((), dtype=torch.int32, device=self.device)
        self.logits = self._capture() if self.graphed else None

    def _step(self) -> torch.Tensor:
        logits, _ = self.step(self.params, self.caches, self.tokens, self.pos)
        return logits

    def __call__(self, params, caches, tokens, pos: int):
        """One step: ``tokens`` (B, 1) a tensor, ``pos`` a host int."""
        _check_bound("StaticDecodeGraph", params, caches, self.params, self._cache_leaves)
        self.tokens.copy_(tokens)
        upload_into(self.pos, np.asarray(pos, np.int32))
        self.calls += 1
        if not self.graphed:
            return self._eager(), caches
        self._replayed()
        return self.logits, caches
