# repro: noqa-file RPR005 -- the __main__ trace-validator CLI prints its report
"""Serving-engine observability: metrics, lifecycle spans, Perfetto export.

Counterpart of ``repro.serve.obs``, transliterated: everything here is
host-side Python; the one device hook, :meth:`Observability.device_span`,
is a ``torch.profiler.record_function`` range where the JAX package has a
``jax.profiler.TraceAnnotation``.  The JAX engine's jit-retrace gauges
(``jit_*_traces``) have no counterpart in an eager engine.

The paper's argument is a runtime/memory-access *breakdown* — where cycles
and off-chip traffic go — and a live serving engine needs the dynamic
counterpart of that breakdown: where engine steps, pool pages, and request
wall-clock go under real scheduling.  This module is that measurement
layer, built on one hard constraint: **zero hot-loop cost**.  Everything
recorded here is host-side int/float bookkeeping captured at the same
scheduling events where the engine already syncs (admission, preemption,
finish, the deferred token flush) — never a new device round-trip.  The
recording methods are marked ``# repro: hot-loop``, and the port's tests
check that no such method calls ``.item()`` or ``.cpu()``.

Three layers:

* :class:`MetricsRegistry` — process-local counters, gauges and fixed-
  bucket histograms (engine steps, decode-batch occupancy, admission-queue
  depth, page-pool gauges, prefix-cache traffic, COW copies,
  preemptions).  Cheap gauges update
  every step; *deep* gauges (the ``free / index_pinned / slot_held``
  breakdown from :meth:`~repro_torch.serve.kvcache.PagedKVCache.audit`) are
  gated behind ``EngineConfig.obs`` because the audit walks the pool.
* **Request-lifecycle spans** — each request carries a
  :class:`RequestTimeline` of phase spans recorded host-side at scheduling
  events only: ``queued`` (arrival → admission, re-opened by preemption),
  ``prefill`` (admission → first token, containing one ``prefill-chunk``
  span per chunk *dispatched*), ``decode`` (first token → finish/preempt).
  Spans nest and close exactly — a preemption closes every open span with
  ``preempted: true`` before re-queueing — and :class:`RequestStats` is a
  **derived view** over the timeline, so step-based and wall-clock timings
  (TTFT in steps AND seconds) come from the same recorded milestones
  instead of two independent bookkeeping paths.
* **Chrome-trace/Perfetto export** — :meth:`Observability.chrome_trace`
  emits one engine-step track plus one track per request (span events,
  preemption instants, counter tracks for occupancy/queue/pool), loadable
  in ``ui.perfetto.dev`` or ``chrome://tracing``.  With deep observability
  on, the engine additionally wraps its decode/chunk dispatches in
  ``torch.profiler.record_function`` ranges so a device trace captured
  with ``torch.profiler.profile()`` lines up with the scheduler-event spans.

Wall timestamps are ``time.perf_counter()`` taken at event-recording time;
with the engine's deferred-sync design a span therefore measures *dispatch*
(host) time for async device work — the scheduling view, which is exactly
what the step-unit columns make deterministic.

Validate an exported trace (CI runs this against the serve smoke)::

    python -m repro_torch.serve.obs trace.json
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Tuple

# --------------------------------------------------------------------------
# Metrics registry
# --------------------------------------------------------------------------


class Counter:
    """Monotonic event count (host int)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0

    def inc(self, n: int = 1) -> None:  # repro: hot-loop
        self.value += n


class Gauge:
    """Point-in-time value (host number); last write wins."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0

    def set(self, v) -> None:  # repro: hot-loop
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``edges`` are inclusive upper bounds, with an
    implicit overflow bucket; ``counts`` has ``len(edges) + 1`` entries."""

    __slots__ = ("name", "help", "edges", "counts", "count", "sum")

    def __init__(self, name: str, help: str = "", edges=(1, 2, 4, 8, 16, 32, 64)):
        self.name, self.help = name, help
        self.edges = tuple(sorted(edges))
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0

    def observe(self, v) -> None:  # repro: hot-loop
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v


class MetricsRegistry:
    """Process-local metric store: get-or-create by (kind, name).

    Names are unique per kind; re-requesting an existing metric returns the
    same object (``help``/``edges`` of the first registration win).
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:  # repro: hot-loop
        m = self._counters.get(name)
        if m is None:
            m = self._counters[name] = Counter(name, help)
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:  # repro: hot-loop
        m = self._gauges.get(name)
        if m is None:
            m = self._gauges[name] = Gauge(name, help)
        return m

    def histogram(self, name: str, help: str = "", edges=None) -> Histogram:  # repro: hot-loop
        m = self._histograms.get(name)
        if m is None:
            kw = {} if edges is None else {"edges": edges}
            m = self._histograms[name] = Histogram(name, help, **kw)
        return m

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dump of every metric (plain ints/floats/lists)."""
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {
                n: {
                    "edges": list(h.edges),
                    "counts": list(h.counts),
                    "count": h.count,
                    "sum": h.sum,
                }
                for n, h in sorted(self._histograms.items())
            },
        }


# --------------------------------------------------------------------------
# Request-lifecycle spans
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    """One phase interval, stamped in both engine steps and wall clock."""

    name: str
    cat: str
    begin_step: int
    t_begin: float
    end_step: int = -1
    t_end: float = -1.0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.end_step < 0

    @property
    def steps(self) -> int:
        return self.end_step - self.begin_step

    @property
    def wall_s(self) -> float:
        return self.t_end - self.t_begin


class RequestTimeline:
    """Span/milestone record for one request, written at scheduling events.

    ``spans`` keeps every span in begin order (closed in place); at most a
    handful are open at once (phase + current chunk) and the engine's
    event discipline closes them exactly — :meth:`close_all` (preemption,
    finish) guarantees no orphans.  ``marks`` are first-occurrence
    milestones (``arrival``/``admitted``/``first_token``/``finish``) as
    ``(step, wall)`` pairs — the single source both the step-based and the
    wall-clock derived stats read from.
    """

    __slots__ = ("spans", "instants", "marks", "_open",
                 "n_preemptions", "cached_prompt_tokens")

    def __init__(self):
        self.spans: List[Span] = []
        self.instants: List[Tuple[str, int, float, Dict[str, Any]]] = []
        self.marks: Dict[str, Tuple[int, float]] = {}
        self._open: Dict[str, Span] = {}
        self.n_preemptions = 0
        self.cached_prompt_tokens = 0

    def begin(self, name, step, t, cat="request", **attrs) -> Span:  # repro: hot-loop
        assert name not in self._open, f"span '{name}' already open"
        span = Span(name, cat, step, t, attrs=attrs)
        self.spans.append(span)
        self._open[name] = span
        return span

    def end(self, name, step, t, **attrs) -> Span:  # repro: hot-loop
        span = self._open.pop(name)
        span.end_step, span.t_end = step, t
        span.attrs.update(attrs)
        return span

    def close_all(self, step, t, **attrs) -> List[Span]:  # repro: hot-loop
        """Close every open span (preemption / finish): no orphans, ever."""
        closed = [self.end(name, step, t, **attrs) for name in list(self._open)]
        return closed

    def instant(self, name, step, t, **attrs) -> None:  # repro: hot-loop
        self.instants.append((name, step, t, attrs))

    def mark(self, name, step, t) -> bool:  # repro: hot-loop
        """Record a first-occurrence milestone; returns True if new."""
        if name in self.marks:
            return False
        self.marks[name] = (step, t)
        return True

    @property
    def open_spans(self) -> List[str]:
        return list(self._open)


class RequestStats:
    """Derived stats view over a :class:`RequestTimeline`.

    Every number here — step-based and wall-clock alike — reads from the
    same recorded span milestones, so TTFT in engine steps and TTFT in
    seconds can never drift apart (the bug this view replaced: the old
    dataclass carried independently-written ``first_token_step`` and
    ``t_first_token`` fields).  Field names match the pre-span dataclass.
    """

    __slots__ = ("_tl",)

    def __init__(self, timeline: RequestTimeline):
        self._tl = timeline

    def _step(self, name: str, default: int = -1) -> int:
        return self._tl.marks.get(name, (default, 0.0))[0]

    def _wall(self, name: str) -> float:
        return self._tl.marks.get(name, (0, 0.0))[1]

    # -- milestones (step, wall) --------------------------------------------
    @property
    def arrival_step(self) -> int:
        return self._step("arrival", 0)

    @property
    def admitted_step(self) -> int:
        return self._step("admitted")

    @property
    def first_token_step(self) -> int:
        return self._step("first_token")

    @property
    def finish_step(self) -> int:
        return self._step("finish")

    @property
    def t_arrival(self) -> float:
        return self._wall("arrival")

    @property
    def t_admitted(self) -> float:
        return self._wall("admitted")

    @property
    def t_first_token(self) -> float:
        return self._wall("first_token")

    @property
    def t_finish(self) -> float:
        return self._wall("finish")

    # -- lifecycle counts ----------------------------------------------------
    @property
    def n_preemptions(self) -> int:
        return self._tl.n_preemptions

    @property
    def cached_prompt_tokens(self) -> int:
        return self._tl.cached_prompt_tokens

    # -- derived -------------------------------------------------------------
    @property
    def queue_steps(self) -> int:
        return self.admitted_step - self.arrival_step

    @property
    def ttft_steps(self) -> int:
        """First-token latency in engine steps (deterministic units)."""
        return self.first_token_step - self.arrival_step

    @property
    def ttft_s(self) -> float:
        """First-token latency in wall seconds, from the same milestones."""
        return self.t_first_token - self.t_arrival

    def decode_tok_s(self, n_generated: int) -> float:
        dt = self.t_finish - self.t_first_token
        return (n_generated - 1) / dt if dt > 0 and n_generated > 1 else float("inf")


# --------------------------------------------------------------------------
# The engine-facing recorder
# --------------------------------------------------------------------------

_NULL_CTX = contextlib.nullcontext()

# cumulative engine/pool values mirrored into counters each step:
# (counter name, attribute path resolved in Observability.step_end)
_OCCUPANCY_EDGES_DEFAULT = tuple(range(17))


class Observability:
    """Per-engine metrics + span recorder, fed at scheduling events.

    ``deep=False`` (the default) records the always-cheap layer: counters,
    cheap gauges, spans — pure host int bookkeeping.  ``deep=True``
    (``EngineConfig.obs``) additionally runs the pool-accounting audit
    every step (``pages_free/index_pinned/slot_held`` gauges) and wraps
    the engine's device dispatches in ``torch.profiler.record_function`` so
    device traces line up with these host spans.  Neither mode touches
    device values: enabling observability cannot change engine outputs.
    """

    def __init__(self, deep: bool = False, max_seqs: int = 0,
                 max_step_spans: int = 200_000):
        self.deep = deep
        self.registry = MetricsRegistry()
        self._clock = time.perf_counter
        self.t0 = self._clock()
        self.timelines: Dict[int, RequestTimeline] = {}  # rid -> timeline
        self.step_spans: List[Span] = []
        self.max_step_spans = max_step_spans
        self._last_decode_batch = 0
        r = self.registry
        # pre-register the full metric set so snapshots are shape-stable
        # between deep on/off runs (deep only changes gauge VALUES)
        for name, help in (
            ("engine_steps_total", "engine iterations run"),
            ("decode_steps_total", "batched decode dispatches"),
            ("prefill_tokens_total", "prompt tokens prefilled (chunk or one-shot)"),
            ("prefill_chunks_total", "prefill chunk dispatches"),
            ("admissions_total", "requests admitted to a slot (incl. re-admissions)"),
            ("finished_total", "requests finished"),
            ("preemptions_total", "requests preempted (LIFO, recompute)"),
            ("prompt_tokens_total", "effective prompt tokens across admissions"),
            ("prefix_cached_tokens_total", "prompt tokens served from the prefix cache"),
            ("prefix_pages_aliased_total", "physical pages aliased at admission"),
            ("cow_copies_total", "copy-on-write page copies"),
            ("pages_allocated_total", "cumulative pool page allocations"),
            ("generated_tokens_total", "tokens generated by finished requests"),
        ):
            r.counter(name, help)
        for name, help in (
            ("queue_depth", "requests waiting in the admission queue"),
            ("decode_batch_occupancy", "slots in the current decode batch"),
            ("pages_free", "free-list pages"),
            ("pages_total", "usable pool pages (excl. null page)"),
            ("prefix_cache_pages", "pages pinned by the radix prefix index"),
            ("pages_index_pinned", "audit: pages held by the prefix index (deep)"),
            ("pages_slot_held", "audit: pages held by slots only (deep)"),
        ):
            r.gauge(name, help)
        occ_edges = tuple(range(max_seqs + 1)) if max_seqs else _OCCUPANCY_EDGES_DEFAULT
        r.histogram("decode_batch_occupancy",
                    "decode batch size per engine step", edges=occ_edges)
        r.histogram("queue_steps", "admission wait per (re-)admission, in steps")
        r.histogram("ttft_steps", "arrival -> first token, in engine steps")
        r.histogram("generated_tokens", "tokens generated per finished request",
                    edges=(1, 2, 4, 8, 16, 32, 64, 128))
        self._counter_base: Dict[str, int] = {}

    # -- plumbing ------------------------------------------------------------

    def _sync_counter(self, name, cumulative) -> None:  # repro: hot-loop
        """Mirror an engine-side cumulative host int into a counter."""
        c = self.registry.counter(name)
        base = self._counter_base.get(name, 0)
        if cumulative > base:
            c.inc(cumulative - base)
            self._counter_base[name] = cumulative

    def timeline(self, req) -> RequestTimeline:  # repro: hot-loop
        tl = req.timeline
        self.timelines.setdefault(req.rid, tl)
        return tl

    def device_span(self, name: str):
        """Context manager around a device dispatch: a
        ``torch.profiler.record_function`` range when deep observability is
        on (so profiler traces align with the host spans), else a shared
        no-op context."""
        if not self.deep:
            return _NULL_CTX
        import torch.profiler

        return torch.profiler.record_function(name)

    # -- request lifecycle events (called by the scheduler) ------------------

    def request_queued(self, req, arrival_step) -> None:  # repro: hot-loop
        now = self._clock()
        tl = self.timeline(req)
        tl.mark("arrival", arrival_step, now)
        tl.begin("queued", arrival_step, now)

    def request_admitted(self, req, step, cached_tokens, prompt_tokens) -> None:  # repro: hot-loop
        now = self._clock()
        tl = self.timeline(req)
        tl.cached_prompt_tokens = cached_tokens
        tl.mark("admitted", step, now)
        queued = tl.end("queued", step, now)
        tl.begin("prefill", step, now,
                 cached_tokens=cached_tokens, prompt_tokens=prompt_tokens)
        r = self.registry
        r.counter("admissions_total").inc()
        r.counter("prompt_tokens_total").inc(prompt_tokens)
        r.counter("prefix_cached_tokens_total").inc(cached_tokens)
        r.histogram("queue_steps").observe(step - queued.begin_step)

    def request_preempted(self, req, step) -> None:  # repro: hot-loop
        now = self._clock()
        tl = self.timeline(req)
        tl.n_preemptions += 1
        tl.close_all(step, now, preempted=True)
        tl.instant("preempt", step, now)
        tl.begin("queued", step, now, requeued=True)
        self.registry.counter("preemptions_total").inc()

    def request_finished(self, req, step) -> None:  # repro: hot-loop
        now = self._clock()
        tl = self.timeline(req)
        tl.mark("finish", step, now)
        tl.close_all(step, now)
        r = self.registry
        r.counter("finished_total").inc()
        r.counter("generated_tokens_total").inc(req.n_generated)
        r.histogram("generated_tokens").observe(req.n_generated)

    # -- engine events -------------------------------------------------------

    def chunk_begin(self, req, step, off, n) -> None:  # repro: hot-loop
        self.timeline(req).begin("prefill-chunk", step, self._clock(),
                                 off=off, tokens=n)

    def chunk_end(self, req, step) -> None:  # repro: hot-loop
        self.timeline(req).end("prefill-chunk", step, self._clock())

    def prefill_complete(self, req, step) -> None:  # repro: hot-loop
        """Final chunk (or one-shot prefill) done: the first token of this
        admission is sampled *now*, and the request joins the decode batch."""
        now = self._clock()
        tl = self.timeline(req)
        tl.end("prefill", step, now)
        if tl.mark("first_token", step, now):
            arrival = tl.marks["arrival"][0]
            self.registry.histogram("ttft_steps").observe(step - arrival)
        tl.begin("decode", step, now)

    def decode_batch(self, occupancy) -> None:  # repro: hot-loop
        self._last_decode_batch = occupancy
        r = self.registry
        r.gauge("decode_batch_occupancy").set(occupancy)
        r.histogram("decode_batch_occupancy").observe(occupancy)

    def step_begin(self) -> float:  # repro: hot-loop
        return self._clock()

    def step_end(self, engine, t0, audit=None) -> None:  # repro: hot-loop
        """Per-step bookkeeping at the step boundary (a sync point the
        engine already owns): cumulative counters, cheap gauges, the
        engine-step span, and — deep only — the audit-backed pool split."""
        now = self._clock()
        r = self.registry
        self._sync_counter("engine_steps_total", engine.step_count)
        self._sync_counter("decode_steps_total", engine.decode_steps)
        self._sync_counter("prefill_tokens_total", engine.prefill_tokens)
        self._sync_counter("prefill_chunks_total", engine.prefill_chunks)
        ps = engine.kv.pool_stats()
        self._sync_counter("prefix_pages_aliased_total", ps["pages_aliased_total"])
        self._sync_counter("cow_copies_total", ps["cow_copies_total"])
        self._sync_counter("pages_allocated_total", ps["pages_allocated_total"])
        queue_depth = len(engine.sched.queue)
        r.gauge("queue_depth").set(queue_depth)
        r.gauge("pages_free").set(ps["pages_free"])
        r.gauge("pages_total").set(ps["pages_total"])
        r.gauge("prefix_cache_pages").set(ps["prefix_cache_pages"])
        if audit is not None:
            r.gauge("pages_index_pinned").set(audit.index_pinned)
            r.gauge("pages_slot_held").set(audit.slot_held)
        step = engine.step_count - 1  # the step that just ran
        if len(self.step_spans) < self.max_step_spans:
            self.step_spans.append(Span(
                "engine-step", "engine", step, t0, step, now,
                {"step": step, "decode_batch": self._last_decode_batch,
                 "queue_depth": queue_depth, "pages_free": ps["pages_free"]},
            ))

    # -- Chrome-trace / Perfetto export --------------------------------------

    _PID = 1

    def chrome_trace(self) -> Dict[str, Any]:
        """The recorded spans as a Chrome-trace JSON object (Perfetto- and
        ``chrome://tracing``-loadable): tid 0 is the engine-step track plus
        occupancy/queue/pool counter tracks; each request gets its own tid
        with phase spans and preemption instants.  Still-open spans (live
        engines) export with ``"open": true`` and a to-now duration."""
        now = self._clock()
        pid = self._PID

        def ts(t: float) -> float:
            return (t - self.t0) * 1e6  # Chrome trace wants microseconds

        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": "repro_torch.serve"}},
            {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
             "args": {"name": "engine steps"}},
        ]
        for span in self.step_spans:
            events.append({
                "ph": "X", "pid": pid, "tid": 0, "name": span.name,
                "cat": span.cat, "ts": ts(span.t_begin),
                "dur": max(0.0, (span.t_end - span.t_begin) * 1e6),
                "args": dict(span.attrs),
            })
            for counter in ("decode_batch", "queue_depth", "pages_free"):
                events.append({
                    "ph": "C", "pid": pid, "tid": 0, "name": counter,
                    "ts": ts(span.t_begin),
                    "args": {counter: span.attrs.get(counter, 0)},
                })
        for tid_i, (rid, tl) in enumerate(self.timelines.items(), start=1):
            events.append({"ph": "M", "pid": pid, "tid": tid_i,
                           "name": "thread_name",
                           "args": {"name": f"request {rid}"}})
            for span in tl.spans:
                t_end = span.t_end if not span.open else now
                args = {"rid": rid, "begin_step": span.begin_step,
                        "end_step": span.end_step, **span.attrs}
                if span.open:
                    args["open"] = True
                events.append({
                    "ph": "X", "pid": pid, "tid": tid_i, "name": span.name,
                    "cat": span.cat, "ts": ts(span.t_begin),
                    "dur": max(0.0, (t_end - span.t_begin) * 1e6),
                    "args": args,
                })
            for name, step, t, attrs in tl.instants:
                events.append({
                    "ph": "i", "pid": pid, "tid": tid_i, "name": name,
                    "s": "t", "ts": ts(t),
                    "args": {"rid": rid, "step": step, **attrs},
                })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.serve.obs",
                          "metrics": self.registry.snapshot()},
        }

    def export_chrome_trace(self, path: str) -> Dict[str, Any]:
        trace = self.chrome_trace()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        return trace


# --------------------------------------------------------------------------
# Report builder (launch driver / JSON report)
# --------------------------------------------------------------------------


def _finite(x: float) -> Optional[float]:
    """inf/nan -> None: the JSON report must be standard-parseable."""
    return x if x == x and abs(x) != float("inf") else None


def build_serve_report(engine, done, wall_s: Optional[float] = None,
                       useful_tokens: Optional[int] = None) -> Dict[str, Any]:
    """Machine-readable serving report, built from the metrics registry and
    the span-derived request stats — the single source the human table in
    ``repro_torch.launch.serve`` prints from (no print-side arithmetic)."""
    kv = engine.kv
    requests = []
    for r in done:
        s = r.stats
        requests.append({
            "rid": r.rid,
            "arrival_step": s.arrival_step,
            "admitted_step": s.admitted_step,
            "queue_steps": s.queue_steps,
            "ttft_steps": s.ttft_steps,
            "ttft_ms": _finite(s.ttft_s * 1e3),
            "preemptions": s.n_preemptions,
            "cached_prompt_tokens": s.cached_prompt_tokens,
            "decode_tok_s": _finite(s.decode_tok_s(len(r.out_tokens))),
            "n_tokens": len(r.out_tokens),
        })
    prompt_tokens = sum(r.prompt_len for r in done)
    cached = sum(r.stats.cached_prompt_tokens for r in done)
    sharing_mode = None
    if kv.sharing:
        sharing_mode = "compute-skipping" if kv.skip_prefill else "memory-dedup"
    report = {
        "engine": {
            "steps": engine.step_count,
            "decode_steps": engine.decode_steps,
            "prefill_tokens": engine.prefill_tokens,
            "prefill_chunks": engine.prefill_chunks,
            "max_seqs": engine.ec.max_seqs,
            "chunked_prefill": engine.ec.chunked_prefill,
            "chunk_size": engine.chunk_size,
            "prefill_tokens_per_step": engine.tokens_per_step,
        },
        "pool": {
            **kv.pool_stats(),
            "page_size": kv.page_size,
            "cache_mb": kv.cache_bytes() / 1e6,
        },
        "prefix_cache": {
            "enabled": kv.sharing,
            "mode": sharing_mode,
            "cached_prompt_tokens": cached,
            "prompt_tokens": prompt_tokens,
            "hit_rate": cached / prompt_tokens if prompt_tokens else 0.0,
        },
        "requests": requests,
        "metrics": engine.obs.registry.snapshot(),
    }
    if wall_s is not None:
        report["workload"] = {
            "num_requests": len(done),
            "useful_tokens": useful_tokens,
            "wall_s": wall_s,
            "tok_s": _finite(useful_tokens / wall_s)
            if useful_tokens is not None and wall_s > 0 else None,
        }
    return report


# --------------------------------------------------------------------------
# Chrome-trace validation (CI gate on the exported file)
# --------------------------------------------------------------------------

_X_REQUIRED = ("name", "cat", "ts", "dur", "pid", "tid")


def validate_chrome_trace(obj, require_request_track: bool = True) -> List[str]:
    """Schema-check a Chrome-trace JSON object; returns problem strings
    (empty list = valid).  Checks the trace-event contract Perfetto relies
    on (typed ``ph``, complete events with non-negative ``ts``/``dur``)
    plus the repo's own: a non-empty engine-step track and — unless
    ``require_request_track=False`` — at least one request span track."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents must be a non-empty array"]
    cats = {"engine": 0, "request": 0}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            problems.append(f"event {i}: missing phase 'ph'")
            continue
        if ph == "X":
            missing = [k for k in _X_REQUIRED if k not in ev]
            if missing:
                problems.append(f"event {i}: X event missing {missing}")
                continue
            if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
                problems.append(f"event {i}: bad ts {ev['ts']!r}")
            if not isinstance(ev["dur"], (int, float)) or ev["dur"] < 0:
                problems.append(f"event {i}: bad dur {ev['dur']!r}")
            cat = ev.get("cat")
            if cat in cats:
                cats[cat] += 1
    if cats["engine"] == 0:
        problems.append("no engine-step track (zero X events with cat='engine')")
    if require_request_track and cats["request"] == 0:
        problems.append("no request span track (zero X events with cat='request')")
    return problems


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate Chrome-trace JSON emitted by repro_torch.serve.obs"
    )
    ap.add_argument("paths", nargs="+", help="trace JSON file(s) to validate")
    ap.add_argument("--allow-empty-requests", action="store_true",
                    help="don't require a request span track")
    args = ap.parse_args(argv)
    rc = 0
    for path in args.paths:
        try:
            with open(path, encoding="utf-8") as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable trace: {e}")
            rc = 1
            continue
        problems = validate_chrome_trace(
            obj, require_request_track=not args.allow_empty_requests
        )
        if problems:
            for p in problems:
                print(f"{path}: {p}")
            rc = 1
        else:
            n = len(obj["traceEvents"])
            print(f"{path}: valid chrome trace ({n} events)")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
