"""Continuous-batching scheduler: queue, admission, preemption, slot re-fill.

Counterpart of ``repro.serve.scheduler``, transliterated (host-side Python
and numpy only).

The scheduler owns request lifecycle and the mapping requests -> batch slots;
the :class:`~repro_torch.serve.kvcache.PagedKVCache` owns pages.  Policy:

* **FIFO admission** with head-of-line blocking: requests are admitted in
  arrival order, each only when a batch slot is free AND the free-page
  budget covers its prompt plus one decode page (no over-subscription at
  admit time; growth is on-demand).
* **On-demand growth**: before every decode step each running slot's page
  table is extended to cover the token about to be written.
* **LIFO preemption**: when growth hits an empty pool, the most recently
  admitted request is preempted — its pages are released and it re-enters
  the *front* of the queue with its generated tokens kept, to be recomputed
  (prompt + generated so far are re-prefilled on re-admission).
* **Slot re-fill**: a finished or preempted request frees its slot the same
  step; the next admission can land in it immediately.

Request lifecycle is recorded as spans/milestones on each request's
:class:`~repro_torch.serve.obs.RequestTimeline` at these scheduling events, and
``Request.stats`` (queue steps, TTFT, decode tok/s) is a derived
:class:`~repro_torch.serve.obs.RequestStats` view over that single record — the
launch driver and benchmarks report latency without instrumenting the
engine.  Wall times are recorded at bookkeeping time: with the engine's
deferred host sync the device may still be draining enqueued steps, so
per-request ``decode_tok_s`` measures enqueue rate; workload-level
tokens/s (useful tokens / engine wall) is the throughput headline.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.obs import (  # noqa: F401  (RequestStats re-exported)
    Observability,
    RequestStats,
    RequestTimeline,
)


@dataclasses.dataclass
class Request:
    """One generation request flowing through the engine."""

    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    arrival_step: int = 0
    # per-request modality inputs beyond the token prompt (e.g. enc-dec
    # audio_embeds).  Kept on the request so preemption-with-recompute can
    # re-run the admission-time installs (encoder pass) on re-admission.
    extras: Optional[Dict] = None
    state: str = "pending"  # pending | waiting | running | finished
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    # tokens generated on-device but not yet copied to out_tokens: the
    # engine defers host syncs between scheduling events, so length
    # bookkeeping must count them (values arrive at the next flush)
    n_pending: int = 0
    # chunked-prefill progress: [0, prefill_target) while the prompt is
    # being fed through the cache page by page; the request joins the
    # decode batch only once the whole (effective) prompt is in.  Reset on
    # preemption — a re-admitted request re-prefills from scratch.
    prefill_pos: int = 0
    prefill_target: int = 0
    # span/milestone record written at scheduling events; ``stats`` below is
    # the derived numeric view (step AND wall TTFT from the same milestones)
    timeline: RequestTimeline = dataclasses.field(default_factory=RequestTimeline)

    @property
    def stats(self) -> RequestStats:
        return RequestStats(self.timeline)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def n_generated(self) -> int:
        return len(self.out_tokens) + self.n_pending

    @property
    def effective_prompt(self) -> np.ndarray:
        """Prompt for (re-)prefill: original + tokens generated pre-preemption."""
        assert self.n_pending == 0, "flush pending tokens before re-prefill"
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)]
        )

    @property
    def prefilling(self) -> bool:
        """Admitted but the prompt is not fully through the cache yet."""
        return self.state == "running" and self.prefill_pos < self.prefill_target

    @property
    def next_pos(self) -> int:
        """Absolute position the next decode step writes for this request
        (the last generated token's position)."""
        return self.prompt_len + self.n_generated - 1

    @property
    def done(self) -> bool:
        return self.n_generated >= self.max_new_tokens

    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


class Scheduler:
    """Drives request state against the paged cache's page budget."""

    def __init__(self, kv, max_seqs: int, obs: Optional[Observability] = None):
        self.kv = kv
        self.max_seqs = max_seqs
        # lifecycle events are recorded here; a standalone scheduler gets a
        # private lightweight recorder, the Engine passes its own
        self.obs = obs if obs is not None else Observability(max_seqs=max_seqs)
        self.pending: List[Request] = []  # not yet arrived (simulated clock)
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * max_seqs
        self._admit_order: List[int] = []  # slots by admission recency
        self.finished: Dict[int, Request] = {}

    # -- intake -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        known = (
            {r.rid for r in self.pending}
            | {r.rid for r in self.queue}
            | {r.rid for r in self.slots if r is not None}
            | set(self.finished)
        )
        if req.rid in known:
            raise ValueError(f"duplicate request id {req.rid}")
        if not self.kv.fits(req.total_len()):
            raise ValueError(
                f"request {req.rid}: {req.total_len()} tokens can never fit "
                f"(max_len {self.kv.max_len}, pool "
                f"{self.kv.allocator.num_pages - 1} pages)"
            )
        self.pending.append(req)
        self.pending.sort(key=lambda r: (r.arrival_step, r.rid))

    def poll_arrivals(self, step: int) -> None:  # repro: hot-loop
        """Move requests whose simulated arrival step has come into the queue."""
        while self.pending and self.pending[0].arrival_step <= step:
            req = self.pending.pop(0)
            req.state = "waiting"
            self.obs.request_queued(req, req.arrival_step)
            self.queue.append(req)

    # -- admission ----------------------------------------------------------

    def admit(self, step: int) -> List[Tuple[int, Request]]:
        """Admit queue-head requests while slots and pages allow (FIFO)."""
        admitted = []
        while self.queue:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                break
            req = self.queue[0]
            if not self.kv.can_admit(req.effective_prompt):
                break  # head-of-line blocks: preserves FIFO fairness
            self.queue.popleft()
            slot = free[0]
            matched = self.kv.admit(slot, req.effective_prompt)
            assert matched is not None, "can_admit passed but admit failed"
            self.slots[slot] = req
            self._admit_order.append(slot)
            req.state = "running"
            req.prefill_target = len(req.effective_prompt)
            # shared-prefix admission: when the family supports compute
            # skipping, prefill resumes at the first uncached page boundary
            # (capped one short of the whole prompt — the final chunk must
            # still run to produce the first token's logits; its write is
            # null-routed by the cache when the position is aliased).
            # Memory-dedup-only families (MoE stacks) alias pages but
            # recompute every token, so they restart at 0.
            req.prefill_pos = (
                min(matched, req.prefill_target - 1)
                if self.kv.skip_prefill else 0
            )
            self.obs.request_admitted(req, step, matched, req.prefill_target)
            admitted.append((slot, req))
        return admitted

    # -- growth / preemption ------------------------------------------------

    def grow_for_decode(self, step: int) -> List[Request]:
        """Ensure every decoding slot can write its next token *privately*;
        preempt LIFO on OOM.  Returns the requests preempted this step.
        Private means mapped AND exclusively owned: a target page shared
        with the prefix index or another slot copies-on-write here
        (:meth:`PagedKVCache.prepare_decode_write`), and a COW allocation
        failure preempts exactly like a growth failure.  Mid-prefill slots
        need no growth (admission reserved their prompt + one decode page)
        but remain preemption victims like any other slot."""
        preempted: List[Request] = []
        for slot in list(self._admit_order):  # oldest first get pages first
            req = self.slots[slot]
            if req is None or req.prefilling:
                continue
            while not (
                self.kv.ensure_capacity(slot, req.next_pos)
                and self.kv.prepare_decode_write(slot, req.next_pos)
            ):
                victim_slot = self._admit_order[-1]  # youngest
                victim = self.preempt(victim_slot, step)
                preempted.append(victim)
                if victim_slot == slot:
                    break  # the needy slot preempted itself
        return preempted

    def preempt(self, slot: int, step: int) -> Request:
        req = self.slots[slot]
        assert req is not None
        self.kv.release(slot)
        self.slots[slot] = None
        self._admit_order.remove(slot)
        req.state = "waiting"
        # re-admission re-prefills (recompute discipline) — though pages the
        # preempted prefill already published to the prefix index let the
        # next admission resume at the first uncached page boundary
        req.prefill_pos = 0
        self.obs.request_preempted(req, step)
        self.queue.appendleft(req)  # preempted requests resume first
        return req

    # -- completion ---------------------------------------------------------

    def finish(self, slot: int, step: int) -> Request:
        req = self.slots[slot]
        assert req is not None
        self.kv.release(slot)
        self.slots[slot] = None
        self._admit_order.remove(slot)
        req.state = "finished"
        self.obs.request_finished(req, step)
        self.finished[req.rid] = req
        return req

    # -- queries ------------------------------------------------------------

    @property
    def running(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    @property
    def decoding(self) -> List[Tuple[int, Request]]:
        """Occupied slots whose prompt is fully in — the decode batch."""
        return [(i, r) for i, r in self.running if not r.prefilling]

    @property
    def prefilling(self) -> List[Tuple[int, Request]]:
        """Occupied slots mid-prefill, oldest admission first (the order
        the chunk budget is spent in — FIFO toward first token)."""
        return [
            (s, self.slots[s]) for s in self._admit_order
            if self.slots[s] is not None and self.slots[s].prefilling
        ]

    def has_work(self) -> bool:
        return bool(self.pending or self.queue or any(
            r is not None for r in self.slots
        ))
