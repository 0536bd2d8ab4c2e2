"""The port's serving engine on the CPU, in fp32, at smoke size.

Parity targets:

* within the port, the continuous :class:`Engine` against single-request
  :meth:`Server.generate`: greedy tokens **equal, token for token** -- CPU
  torch gives that here for both decode backends (``"cuda"`` runs the
  kernels' plain versions on the CPU), so no margin rule is needed;
* across frameworks, the port's ``Server.generate`` against the JAX
  package's on the same weights: equal tokens except where the JAX
  baseline's top-2 logit margin is below 1e-3 at the first divergence
  (near-ties may flip between frameworks).  The JAX ``Engine``'s tokens are
  not a target (ROADMAP.md queue 3 lists its serving tests as flaky).

Covered: slot re-fill, multi-chunk prompts, chunked vs one-shot prefill,
preemption (also mid-prefill), a shared prefix with copy-on-write, EOS,
inactive slots, the pool staying in place, observability, the hot-loop sync
rule and the CLI.  Every engine run ends on a clean ``CacheAudit``.
"""
import ast
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as JC
import repro_torch.configs as TC
import repro_torch.kernels as tk
from repro.models import model as JM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import Server as JServer
from repro_torch.models import model as TM
from repro_torch.serve import (
    Engine,
    EngineConfig,
    PageAllocator,
    PagedCacheConfig,
    PagedKVCache,
    PrefixIndex,
    ServeConfig,
    Server,
    build_serve_report,
    make_requests,
    run_static_waves,
    validate_chrome_trace,
)
from repro_torch.serve import engine as engine_mod

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["minicpm-2b", "starcoder2-7b"]
BACKENDS = ["reference", "cuda"]
MARGIN = 1e-3


def _cfg(arch="minicpm-2b", **over):
    return dataclasses.replace(TC.get_config(arch, smoke=True, dtype=torch.float32), **over)


_PARAMS = {}


def _params(arch):
    """The JAX package's weights for ``arch`` (seed 0), in both packages."""
    if arch not in _PARAMS:
        jcfg = JC.get_config(arch, smoke=True, dtype=jnp.float32)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[arch]


def _prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]


def _baseline(cfg, params, prompts, max_new):
    srv = Server(cfg, params, ServeConfig(max_len=64), device="cpu")
    return [srv.generate({"tokens": p[None]}, max_new)[0] for p in prompts]


def _drained(eng):
    """A drained engine accounts for every page: a clean audit, no slot
    holding pages, free + prefix-pinned == total."""
    stats = eng.kv.audit()
    assert stats.slot_held == 0 and not eng.kv._pages, eng.kv._pages
    assert stats.free + stats.index_pinned == stats.total
    return stats


def _run(cfg, params, ec, prompts, max_new, gap=2):
    eng = Engine(cfg, params, ec, device="cpu")
    ptrs = eng.kv.pool_ptrs()
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, rid=i, arrival_step=gap * i)
    reqs = eng.run()
    assert eng.kv.pool_ptrs() == ptrs  # the pool was written in place, never copied
    _drained(eng)
    return eng, reqs


def _assert_tokens(reqs, base):
    assert len(reqs) == len(base) and all(r.state == "finished" for r in reqs)
    for r, b in zip(reqs, base):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), b)


# --------------------------------------------------------------------------
# Page allocator / prefix index / cache manager units
# --------------------------------------------------------------------------

def test_page_allocator_refcount_cycle():
    a = PageAllocator(8)  # 7 usable pages (page 0 reserved)
    got = a.alloc(3)
    assert len(got) == 3 and a.num_free == 4 and 0 not in got
    assert a.alloc(5) is None and a.num_free == 4  # no partial allocation
    a.ref(got[:1])
    assert a.refcount(got[0]) == 2
    assert a.unref(got) == got[1:]  # the first page survives its extra ref
    assert a.unref(got[:1]) == got[:1] and a.num_free == 7
    with pytest.raises(ValueError):
        a.unref([0])  # the null page is never tracked
    with pytest.raises(ValueError):
        a.ref([got[0]])  # cannot alias a free page
    got2 = a.alloc(1)
    a.unref(got2)
    with pytest.raises(ValueError):
        a.unref(got2)  # double free


def test_prefix_index_radix_lookup_insert_evict():
    a = PageAllocator(8)
    idx = PrefixIndex(4, a)
    toks = np.arange(10, dtype=np.int32)
    pages = a.alloc(3)
    idx.insert(toks, pages, 10)  # two full pages published
    assert idx.num_pages == 2 and a.refcount(pages[0]) == 2
    assert idx.lookup(toks[:8]) == (pages[:2], 8)
    assert idx.lookup(toks[:6]) == (pages[:2], 6)  # tail matches inside page 2
    assert idx.lookup(np.array([9, 9, 9, 9], np.int32)) == ([], 0)
    a.unref(pages)
    assert idx.reclaimable_count() == 2
    assert idx.evict_lru() == pages[1]  # leaf first
    assert idx.evict_lru() == pages[0] and idx.evict_lru() is None


def test_kvcache_admission_accounting_and_device_rule():
    cfg = _cfg(block=4)
    kv = PagedKVCache(cfg, PagedCacheConfig(max_seqs=2, max_len=16, num_pages=6),
                      device="cpu")
    assert kv.page_size == 4 and kv.pages_for(5) == 2
    assert kv.can_admit(10) and kv.admit(0, 10) is not None
    assert kv.num_free_pages == 2 and not kv.can_admit(10) and kv.admit(1, 10) is None
    assert kv.ensure_capacity(0, 11) and kv.num_free_pages == 2
    assert kv.ensure_capacity(0, 12) and kv.num_free_pages == 1
    kv.release(0)
    assert kv.num_free_pages == 5 and int(kv.page_table().max()) == 0
    assert kv.fits(16) and not kv.fits(17)
    kv.audit()
    with pytest.raises(NotImplementedError, match="queue 1 item 26"):
        PagedKVCache(cfg, PagedCacheConfig(), mesh=object(), device="cpu")


# --------------------------------------------------------------------------
# Continuous batching == single-request baseline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_single_request(arch, backend):
    """3 requests through 2 slots (a slot re-fill), staggered arrivals,
    prompts of 2 and 3 page-sized chunks: tokens equal the port's
    single-request generate exactly."""
    cfg = _cfg(arch, block=8)
    params = _params(arch)[1]
    prompts = _prompts(0, (12, 9, 20))
    base = _baseline(cfg, params, prompts, 8)
    tk.reset_launch_counts()
    eng, reqs = _run(cfg, params, EngineConfig(max_seqs=2, max_len=32, page_size=8,
                                               backend=backend), prompts, 8)
    _assert_tokens(reqs, base)
    assert eng.prefill_chunks == 2 + 2 + 3 and eng.decode_steps > 0
    assert all(n == 0 for n in tk.launch_counts().values())  # CPU: plain versions only


@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_jax_server(arch):
    """The port's single-request generate against the JAX package's on the
    same weights, under the margin rule."""
    jp, tp = _params(arch)
    jcfg = dataclasses.replace(JC.get_config(arch, smoke=True, dtype=jnp.float32), block=8)
    cfg = _cfg(arch, block=8)
    prompts = _prompts(1, (12, 9, 14))
    got = _baseline(cfg, tp, prompts, 8)
    jsrv = JServer(jcfg, jp, JServeConfig(max_len=64))
    for p, g in zip(prompts, got):
        want = np.asarray(jsrv.generate({"tokens": jnp.asarray(p)[None]}, 8)[0])
        if np.array_equal(g, want):
            continue
        i = int(np.argmax(g != want))  # first divergence: a near-tie in JAX
        logits, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(
            np.concatenate([p, want[:i]]))[None]})
        top2 = np.sort(np.asarray(logits)[0, -1])[-2:]
        assert top2[1] - top2[0] < MARGIN, (i, top2)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_matches_unchunked(arch):
    cfg = _cfg(arch, block=8)
    params = _params(arch)[1]
    prompts = _prompts(2, (20, 5, 17))
    base = _baseline(cfg, params, prompts, 6)
    for chunked in (True, False):
        _, reqs = _run(cfg, params, EngineConfig(max_seqs=2, max_len=32, page_size=8,
                                                 chunked_prefill=chunked), prompts, 6)
        _assert_tokens(reqs, base)


@pytest.mark.parametrize("backend", BACKENDS)
def test_preemption_recompute_preserves_outputs(backend):
    """A pool too small for all growth preempts LIFO; the preempted request
    re-prefills (prompt + generated) and still matches the baseline."""
    cfg = _cfg(block=4)
    params = _params("minicpm-2b")[1]
    prompts = _prompts(0, (10, 10, 10))
    base = _baseline(cfg, params, prompts, 10)
    _, reqs = _run(cfg, params, EngineConfig(max_seqs=3, max_len=20, page_size=4,
                                             num_pages=9, backend=backend), prompts, 10,
                   gap=0)
    assert sum(r.stats.n_preemptions for r in reqs) >= 1
    _assert_tokens(reqs, base)


def test_mid_prefill_preemption_and_resume():
    """A request preempted in the middle of its chunked prefill restarts
    cleanly on re-admission and still matches the baseline."""
    cfg = _cfg(block=4)
    params = _params("minicpm-2b")[1]
    short, long = _prompts(11, (8, 16))
    base = _baseline(cfg, params, [short, long], 8)
    eng = Engine(cfg, params, EngineConfig(max_seqs=2, max_len=24, page_size=4,
                                           num_pages=9, prefill_tokens_per_step=4),
                 device="cpu")
    a = eng.submit(short, 8, rid=0)
    b = eng.submit(long, 8, rid=1)
    preempted_mid_prefill = False
    while eng.sched.has_work():
        mid = b.prefilling and 0 < b.prefill_pos
        eng.step()
        preempted_mid_prefill |= mid and b.state == "waiting"
    eng._flush_pending()
    assert preempted_mid_prefill and b.stats.n_preemptions >= 1
    np.testing.assert_array_equal(np.asarray(a.out_tokens), base[0])
    np.testing.assert_array_equal(np.asarray(b.out_tokens), base[1])
    _drained(eng)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_shared_prefix_copy_on_write(arch, backend):
    """The second prompt is the first 20 tokens of the first: it aliases the
    cached pages, including the partial tail page, and its first decode write
    copies that page (COW) -- outputs still equal the baseline."""
    cfg = _cfg(arch, block=8)
    params = _params(arch)[1]
    rng = np.random.default_rng(21)
    shared = rng.integers(0, 512, size=(24,)).astype(np.int32)
    pa = np.concatenate([shared, rng.integers(0, 512, size=(3,))]).astype(np.int32)
    pc = shared[:20].copy()
    base = _baseline(cfg, params, [pa, pc], 8)
    eng, reqs = _run(cfg, params, EngineConfig(max_seqs=2, max_len=48, page_size=8,
                                               backend=backend), [pa, pc], 8, gap=4)
    _assert_tokens(reqs, base)
    assert eng.kv.cow_copies >= 1
    assert [r.stats.cached_prompt_tokens for r in reqs] == [0, 20]


def test_eos_stops_early_and_matches_baseline_prefix():
    cfg = _cfg(block=8)
    params = _params("minicpm-2b")[1]
    prompts = _prompts(4, (9, 12))
    base = _baseline(cfg, params, prompts, 8)
    eos = int(base[0][3])
    eng, reqs = _run(cfg, params, EngineConfig(max_seqs=2, max_len=32, page_size=8,
                                               eos_id=eos), prompts, 8)
    for r, b in zip(reqs, base):
        stop = list(b).index(eos) + 1 if eos in b else len(b)
        assert r.out_tokens == list(b[:stop])


def test_temperature_sampling_is_schedule_independent():
    cfg = _cfg(block=8)
    params = _params("minicpm-2b")[1]
    prompts = _prompts(5, (9, 12, 7))
    outs = []
    for max_seqs in (1, 3):
        _, reqs = _run(cfg, params, EngineConfig(max_seqs=max_seqs, max_len=32, page_size=8,
                                                 temperature=0.8, seed=3), prompts, 6)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]


def test_static_waves_match_single_request():
    cfg = _cfg(block=8)
    params = _params("minicpm-2b")[1]
    reqs = make_requests(cfg.vocab_size, 4, prompt_len=8, max_new=6, seed=1,
                         mean_interarrival=2.0)
    from repro.serve import make_requests as jax_make_requests

    for mine, theirs in zip(reqs, jax_make_requests(cfg.vocab_size, 4, prompt_len=8,
                                                    max_new=6, seed=1, mean_interarrival=2.0)):
        assert mine.keys() == theirs.keys()  # the JAX workload, number for number
        for key in mine:
            np.testing.assert_array_equal(mine[key], theirs[key])
    srv = Server(cfg, params, ServeConfig(max_len=32), device="cpu")
    outs = run_static_waves(srv, reqs, 2)
    for r in reqs:
        want = srv.generate({"tokens": r["prompt"][None]}, r["max_new_tokens"])[0]
        np.testing.assert_array_equal(outs[r["rid"]], want)
    # Engine.generate, the drop-in for Server.generate on one batch
    batch = {"tokens": np.stack([r["prompt"] for r in reqs])}
    eng = Engine(cfg, params, EngineConfig(max_seqs=2, max_len=32, page_size=8), device="cpu")
    np.testing.assert_array_equal(eng.generate(batch, 6), srv.generate(batch, 6))
    _drained(eng)


# --------------------------------------------------------------------------
# Entry-point rules, observability, the hot loop, the CLI
# --------------------------------------------------------------------------

def test_engine_refuses_unported_families_mesh_and_backends():
    params = _params("minicpm-2b")[1]
    cfg = _cfg(block=8)
    with pytest.raises(NotImplementedError, match="queue 1 item 26"):
        Engine(cfg, params, EngineConfig(), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 26"):
        Server(cfg, params, ServeConfig(), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        Engine(cfg, params, EngineConfig(backend="pallas"), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 21"):
        PagedKVCache(TC.get_config("mamba2-130m", smoke=True), PagedCacheConfig(),
                     device="cpu")
    with pytest.raises(ValueError, match="can never fit"):
        Engine(cfg, params, EngineConfig(max_seqs=1, max_len=8, page_size=4),
               device="cpu").submit(np.zeros(6, np.int32), 8)


def test_observability_report_and_trace(tmp_path):
    cfg = _cfg(block=8)
    params = _params("minicpm-2b")[1]
    eng = Engine(cfg, params, EngineConfig(max_seqs=2, max_len=32, page_size=8, obs=True,
                                           debug_audit=True), device="cpu")
    for i, p in enumerate(_prompts(6, (12, 9, 14))):
        eng.submit(p, 5, rid=i, arrival_step=i)
    done = eng.run()
    report = build_serve_report(eng, done, wall_s=1.0, useful_tokens=15)
    assert report["engine"]["decode_steps"] == eng.decode_steps
    assert [r["n_tokens"] for r in report["requests"]] == [5, 5, 5]
    m = eng.metrics()
    assert m["counters"]["finished_total"] == 3 and m["counters"]["decode_steps_total"] > 0
    trace = eng.export_trace(str(tmp_path / "trace.json"))
    assert validate_chrome_trace(trace) == []
    assert validate_chrome_trace(json.loads((tmp_path / "trace.json").read_text())) == []
    _drained(eng)


def _hot_loop_functions():
    src = inspect.getsource(engine_mod)
    lines = src.splitlines()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.FunctionDef) and "repro: hot-loop" in lines[node.lineno - 1]:
            yield node.name, lines[node.lineno - 1:node.end_lineno]


def test_hot_loop_has_no_host_sync_outside_the_sanctioned_points():
    """The deferred host sync: the methods marked ``# repro: hot-loop`` call
    neither ``.item()`` nor ``.cpu()``, except on the lines marked as the
    sanctioned sync points (first-token sampling and the deferred flush)."""
    seen = set()
    for name, body in _hot_loop_functions():
        seen.add(name)
        for line in body:
            if "sanctioned sync" in line:
                continue
            assert ".item()" not in line and ".cpu()" not in line, (name, line)
    assert {"step", "_decode_once", "_admit_and_prefill", "_prefill_one_chunk"} <= seen


def test_cli_serves_on_the_cpu_and_refuses_unported_families(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    report = tmp_path / "report.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "starcoder2-7b",
           "--smoke", "--device", "cpu", "--num-requests", "3", "--max-seqs", "2",
           "--prompt-len", "10", "--max-new", "5", "--page-size", "8", "--engine", "both",
           "--json-report", str(report)]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[continuous]" in r.stdout and "[static-wave]" in r.stdout
    got = json.loads(report.read_text())
    assert got["device"] == "cpu" and got["backend"] == "cuda"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "mamba2-130m", "--smoke", "--device", "cpu"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "queue 1 item 21" in r.stderr
