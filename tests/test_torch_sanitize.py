"""The runtime half of the port's correctness backstop, on the CPU.

Counterpart of ``tests/test_sanitize.py`` (which runs behind
``--sanitize``); these run in every tier-1 run.  The static half is
``repro_torch.analysis.staticcheck``; this file enforces the same
invariants on a live engine:

* **sync guard** -- the engine's decode and chunk steps run under
  :func:`repro_torch.analysis.torchcheck.harness.sync_guard`, the
  counterpart of ``jax.transfer_guard("disallow")``: on the CPU a dispatch
  mode that raises on ``aten._local_scalar_dense`` (what ``.item()``,
  ``int(t)`` and ``bool(t)`` reach), ``aten.nonzero`` and the other
  data-dependent shapes (boolean-mask indexing, ``masked_select``,
  ``unique``); on the card ``torch.cuda.set_sync_debug_mode("error")``
  (``chip_smoke.py`` phase 20).
  The arguments are evaluated at the call site, outside the guard;
* **retrace budget** -- the distinct input signatures the chunk and decode
  steps see over 20 prompt lengths (each one a CUDA-graph capture);
* **refcount audit** -- ``EngineConfig(debug_audit=True)`` cross-checks the
  page-pool accounting after every engine step.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as C
from repro_torch.analysis.torchcheck.harness import guarded, signature, sync_guard
from repro_torch.models import model as M
from repro_torch.serve import Engine, EngineConfig


def _cfg(**over):
    cfg = C.get_config("minicpm-2b", smoke=True, dtype=torch.float32)
    return dataclasses.replace(cfg, **over)


def _params(cfg, seed=0):
    return M.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32) for n in lengths]


def _serve(cfg, params, prompts, ec, guard=False, new=8):
    eng = Engine(cfg, params, ec, device="cpu")
    calls = [0]
    if guard:
        eng._decode = guarded(eng._decode, "cpu", calls)
        eng._chunk_fn = guarded(eng._chunk_fn, "cpu", calls)
    for i, p in enumerate(prompts):
        eng.submit(p, new, rid=i, arrival_step=i)
    return eng, eng.run(), calls[0]


@pytest.mark.parametrize("sync", [
    lambda t: t.sum().item(), lambda t: int(t[0]), lambda t: bool(t.any()),
    lambda t: float(t.max()), lambda t: t.nonzero(), lambda t: t[t > 1],
    lambda t: t.masked_select(t > 1), lambda t: torch.unique(t),
], ids=["item", "int", "bool", "float", "nonzero", "mask_index", "masked_select", "unique"])
def test_sync_guard_raises_on_each_sync(sync):
    t = torch.arange(4)
    with pytest.raises(RuntimeError, match="sync guard"):
        with sync_guard("cpu"):
            sync(t)
    sync(t)  # outside the guard: allowed


def test_guard_leaves_call_site_arguments_outside():
    """Arguments are evaluated before the guarded body, as with
    ``jax.transfer_guard``: the staging at the call site stays legal."""
    calls = [0]
    step = guarded(lambda x, n: x * n, "cpu", calls)
    t = torch.arange(4)
    assert step(t, int(t[1])).tolist() == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="sync guard"):
        guarded(lambda x: x[x > 0], "cpu")(t)  # boolean mask: nonzero
    assert calls == [1]


def test_engine_steps_run_under_sync_guard():
    """Chunked prefill + paged decode with every chunk and decode step
    guarded: outputs must match the unguarded engine exactly, proving the
    hot loop's only host syncs are the sanctioned deferred ones."""
    cfg = _cfg(block=8)
    params = _params(cfg)
    prompts = _prompts(cfg, (12, 9, 14))
    ec = EngineConfig(max_seqs=2, max_len=32, page_size=8)
    _, ref, _ = _serve(cfg, params, prompts, ec)
    eng, reqs, calls = _serve(cfg, params, prompts, ec, guard=True)
    assert len(reqs) == 3 and all(r.state == "finished" for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref]
    assert calls == eng.decode_steps + eng.prefill_chunks > 0


def test_obs_enabled_engine_under_sync_guard():
    """Deep observability adds NO hot-loop host syncs: the obs=True engine
    runs with its steps guarded and its greedy outputs match the gated-off
    engine bit for bit."""
    cfg = _cfg(block=8)
    params = _params(cfg)
    prompts = _prompts(cfg, (12, 9, 14))
    _, ref, _ = _serve(cfg, params, prompts, EngineConfig(max_seqs=2, max_len=32, page_size=8))
    eng, reqs, calls = _serve(cfg, params, prompts, EngineConfig(
        max_seqs=2, max_len=32, page_size=8, obs=True), guard=True)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref]
    assert calls > 0
    # deep collection really ran: per-step audit gauges + engine-step spans
    g = eng.metrics()["gauges"]
    assert g["pages_free"] + g["pages_index_pinned"] == g["pages_total"]
    assert len(eng.obs.step_spans) == eng.step_count
    assert all(r.timeline.open_spans == [] for r in reqs)


def test_engine_retrace_budget():
    """20 distinct prompt lengths: the chunk step may see one full-chunk
    signature plus the bucketed final-chunk set; the decode step exactly
    one -- each distinct signature would be a CUDA-graph capture."""
    cfg = _cfg(block=8)
    eng = Engine(cfg, _params(cfg), EngineConfig(max_seqs=2, max_len=80, page_size=8),
                 device="cpu")
    seen = {"chunk": set(), "decode": set()}

    def recording(fn, key):
        def run(*args):
            seen[key].add(signature(args))
            return fn(*args)
        return run

    eng._chunk_fn = recording(eng._chunk_fn, "chunk")
    eng._decode = recording(eng._decode, "decode")
    rng = np.random.default_rng(9)
    for i, n in enumerate(range(1, 41, 2)):
        eng.submit(rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32), 2, rid=i)
    eng.run()
    budget = 1 + int(math.log2(eng.chunk_size)) + 1
    assert 1 < len(seen["chunk"]) <= budget
    assert len(seen["decode"]) == 1


def test_debug_audit_runs_every_step():
    """A shared-prefix + slot-refill + growth workload with
    ``debug_audit=True``: the refcount auditor cross-checks the allocator
    after every engine step, and the drained pool balances exactly."""
    cfg = _cfg(block=8)
    prompts = _prompts(cfg, (16, 9, 14))
    prompts[2][:8] = prompts[0][:8]  # page-aligned shared prefix
    eng = Engine(cfg, _params(cfg), EngineConfig(max_seqs=2, max_len=32, page_size=8,
                                                 debug_audit=True), device="cpu")
    audits = [0]
    audit = eng.kv.audit

    def counted():
        audits[0] += 1
        return audit()

    eng.kv.audit = counted
    for i, p in enumerate(prompts):
        eng.submit(p, 8, rid=i, arrival_step=i)
    reqs = eng.run()
    assert len(reqs) == 3 and all(r.state == "finished" for r in reqs)
    assert audits[0] == eng.step_count > 0
    stats = audit()
    assert stats.slot_held == 0
    assert stats.free + stats.index_pinned == stats.total


def test_chip_smoke_analysis_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 20 on the CPU at the smoke config: torchcheck's
    inventory clean against ``torchcheck.budgets`` with the kernel steps
    left out, the reference twins' bytes those of the budgets, the engine
    under the guard with tokens equal to the unguarded one's, and a ``1 x 2``
    rank's placed weights each in a storage of its own."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    out = cs.analysis_phase(torch, device="cpu", full=False)
    assert sorted(out["smoke"]["left_out"]) == ["cow_copy", "decode_step"]
    assert out["smoke"]["findings"] == [] and all(out["smoke"]["equal_to_budgets"].values())
    assert out["full"]["findings"] == []
    assert out["guard"]["tokens_equal"]
    assert all(not row["views"] and row["storage_bytes"] == row["bytes"]
               for row in out["placement"].values())
    assert out["guard"]["guarded_calls"] == \
        out["guard"]["decode_steps"] + out["guard"]["prefill_chunks"]
