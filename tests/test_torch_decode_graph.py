"""The continuous engine's decode-step runner (``serve/graphs.py``) on the CPU.

On the card :class:`DecodeGraph` captures the decode step once as a CUDA
graph and replays it on static buffers; on the CPU it keeps the same
buffers, copies and bookkeeping around an eager call, which these tests
drive (the capture itself: ``chip_smoke.py`` phase ``graph`` and
``tests/test_torch_decode_graph_cuda.py``).  At smoke size, fp32, pages of
8 tokens:

* for dense/GQA, MLA, MoE, SWA, SSM, the hybrid and enc-dec, every decode
  step the runner took inside a served run -- after the engine's own chunks
  -- against the JAX package's compiled step,
  ``repro.serve.engine._decode_paged_fn``, on the same weights (the JAX
  package's ``init_params``), the same pool (the port's, copied) and the
  same inputs: logits within 1e-4 (the JAX suite's end-to-end tolerance)
  on the active slots, greedy tokens equal wherever JAX's top-2 margin
  exceeds that tolerance;
* the warm-up step, every slot inactive, leaves every pool leaf bit for bit
  but the null page, for every family;
* over a run with admission, copy-on-write, preemption and slot refill,
  every pool leaf, the page-table mirror and the runner's buffers keep
  their storage, the page table is right after each change, and the tokens
  equal ``Server.generate``'s exactly;
* a greedy run flushed only at its end gives the tokens of one flushed
  every step (the graph's output buffer is overwritten by every replay);
* an engine on a ``1 x 2`` mesh does not use the runner;
* the launch-count bookkeeping of warm-up, capture and replay, with fake
  counters;
* two engines of different ``max_seqs`` in one process, and the paged
  kernels' workspaces a runner owns.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as JC
import repro_torch.configs as TC
import repro_torch.kernels as tk
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import tree as T
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import adapters as A
from repro_torch.models import model as TM
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server
from repro_torch.serve.engine import step_fns
from repro_torch.serve.graphs import DecodeGraph
from repro_torch.serve.kvcache import NULL_PAGE

TOL = 1e-4  # logits (the JAX suite's end-to-end tolerance)
PAGE = 8
DENSE = dict(family="dense", n_experts=0, n_shared_experts=0, top_k=0, moe_d_ff=0,
             first_k_dense=0, mtp_depth=0, d_ff=96)
FAMILIES = {
    "dense": ("starcoder2-7b", {}),
    "mla": ("deepseek-v3-671b", DENSE),
    "moe": ("granite-moe-3b-a800m", {}),
    "swa": ("h2o-danube-3-4b", {}),
    "ssm": ("mamba2-130m", {}),
    "hybrid": ("hymba-1.5b", {}),
    "encdec": ("whisper-tiny", {}),
}

_SETUPS = {}


def _setup(family):
    """The JAX package's weights (seed 0) in both packages, fp32."""
    if family not in _SETUPS:
        arch, over = FAMILIES[family]
        over = {"block": PAGE, **over}
        jc = dataclasses.replace(JC.get_config(arch, smoke=True, dtype=jnp.float32), **over)
        tc = dataclasses.replace(TC.get_config(arch, smoke=True, dtype=torch.float32), **over)
        jp = JM.init_params(jc, jax.random.PRNGKey(0))
        tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _SETUPS[family] = (jc, tc, jp, tp)
    return _SETUPS[family]


@pytest.fixture(autouse=True)
def _no_launches_on_the_cpu():
    tk.reset_launch_counts()
    yield
    assert all(n == 0 for n in tk.launch_counts().values()), "a kernel launched on the CPU"


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]


def _extras(cfg, n, seed=5):
    """Per-request audio for an enc-dec config, else none."""
    if not cfg.n_encoder_layers:
        return [None] * n
    rng = np.random.default_rng(seed)
    return [{"audio_embeds": rng.standard_normal((1, cfg.encoder_seq, cfg.d_model))
             .astype(np.float32)} for _ in range(n)]


def _engine(tc, tp, prompts, ec, max_new, gap=1, extras=None):
    eng = Engine(tc, tp, ec, device="cpu")
    extras = extras or [None] * len(prompts)
    for i, (p, x) in enumerate(zip(prompts, extras)):
        eng.submit(p, max_new, rid=i, arrival_step=gap * i, extras=x)
    return eng


def _np_tree(pool):
    return T.tree_map(lambda t: t.numpy().copy(), pool)


def _paged_keys(cfg):
    """(segment, adapter key) of every paged pool: page axis 1, page 0 the
    null page."""
    return {(f"seg{si}", ad.key) for si, (kind, _) in enumerate(A.layer_segments(cfg))
            for ad in A.adapters_for(cfg, kind) if ad.paged}


# --------------------------------------------------------------------------
# (1) every family's decode steps against the JAX package's compiled step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_runner_steps_match_jax_decode_paged_fn(family):
    """Three requests (9, 13, 6 tokens; 2 slots, so the third refills)
    through the engine; each decode step's inputs and the pool before it
    are recorded from the runner, then JAX's jitted step runs on them."""
    jc, tc, jp, tp = _setup(family)
    prompts = _prompts(1, (9, 13, 6), tc.vocab_size)
    eng = _engine(tc, tp, prompts, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE), 3,
                  extras=_extras(tc, 3))
    runner = eng._decode
    assert isinstance(runner, DecodeGraph) and not runner.graphed
    steps = []

    def recording(params, pool, tokens, seq_pos, table, active):
        before = _np_tree(pool)
        greedy, logits, pool = runner(params, pool, tokens, seq_pos, table, active)
        steps.append({"pool": before, "tokens": runner.tokens.numpy().copy(),
                      "seq_pos": runner.seq_pos.numpy().copy(),
                      "table": runner.table.numpy().copy(),
                      "active": runner.active.numpy().copy(),
                      "greedy": greedy.numpy().copy(), "logits": logits.numpy().copy()})
        return greedy, logits, pool

    eng._decode = recording
    reqs = eng.run()
    assert len(reqs) == 3 and len(steps) == eng.decode_steps >= 3
    step = JE._decode_paged_fn(jc)
    for i, s in enumerate(steps):
        np.testing.assert_array_equal(s["seq_pos"][~s["active"]], 0)
        jg, jl, _ = step(jp, jax.tree.map(jnp.asarray, s["pool"]), jnp.asarray(s["tokens"]),
                         jnp.asarray(s["seq_pos"]), jnp.asarray(s["table"]),
                         jnp.asarray(s["active"]))
        jl = np.asarray(jl)[s["active"], -1]
        got = s["logits"][s["active"], -1]
        err = float(np.abs(got - jl).max())
        assert err <= TOL, (i, err)
        top2 = np.sort(jl, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > TOL
        np.testing.assert_array_equal(s["greedy"][s["active"]][sure],
                                      np.asarray(jg)[s["active"]][sure])


# --------------------------------------------------------------------------
# (4) the warm-up keeps the pool but its null page, every family
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_warm_up_keeps_every_pool_leaf_but_the_null_page(family):
    """A pool with live slots -- one decoding, one mid-prefill -- and a
    runner built on it: its warm-up step (every slot inactive, the table on
    the null page) changes no bit of any pool leaf outside the null page."""
    _, tc, _, tp = _setup(family)
    prompts = _prompts(2, (10, 20), tc.vocab_size)
    ec = EngineConfig(max_seqs=2, max_len=40, page_size=PAGE, prefill_tokens_per_step=8)
    eng = _engine(tc, tp, prompts, ec, 6, gap=0, extras=_extras(tc, 2))
    while not (eng.decode_steps and eng.sched.prefilling):
        eng.step()
    before = _np_tree(eng.kv.data)
    assert any(np.any(leaf) for leaf in T.leaves(before))
    runner = DecodeGraph(step_fns(tc)["decode_step"][0], eng.params, eng.kv.data,
                         ec.max_seqs, eng.kv.max_pages_per_seq, "cpu")
    assert not runner.active.any() and not runner.table.any()
    paged = _paged_keys(tc)
    for seg, tree in eng.kv.data.items():
        for key, leaves in tree.items():
            for name, leaf in leaves.items():
                got, want = leaf.numpy(), before[seg][key][name]
                if (seg, key) in paged:
                    got, want = np.delete(got, NULL_PAGE, 1), np.delete(want, NULL_PAGE, 1)
                np.testing.assert_array_equal(got, want, err_msg=f"{seg}/{key}/{name}")


# --------------------------------------------------------------------------
# (2) stable storages over admission, COW, preemption and refill
# --------------------------------------------------------------------------

def test_buffers_keep_their_storage_through_cow_preemption_and_refill():
    """Five prompts just under a page boundary (so decoding slots grow), the
    second the first's prefix (its shared tail page copies on write), on 4
    slots and 8 usable pages of 4 tokens (growth preempts)."""
    _, tc, _, tp = _setup("dense")
    prompts = _prompts(21, (11, 6, 11, 7, 8), tc.vocab_size)
    prompts[1] = prompts[0][:6].copy()
    max_new = 12
    srv = Server(tc, tp, ServeConfig(max_len=64), device="cpu")
    base = [srv.generate({"tokens": p[None]}, max_new)[0] for p in prompts]
    ec = EngineConfig(max_seqs=4, max_len=24, page_size=4, num_pages=9)
    eng = _engine(tc, tp, prompts, ec, max_new, gap=2)
    runner = eng._decode
    buffers = [runner.tokens, runner.seq_pos, runner.table, runner.active,
               runner.greedy, runner.logits]
    ptrs = [t.data_ptr() for t in buffers]
    pool_ptrs = eng.kv.pool_ptrs()
    table_dev = eng.kv.page_table()
    table_ptr = table_dev.data_ptr()
    calls = [0]

    def checked(params, pool, tokens, seq_pos, table, active):
        out = runner(params, pool, tokens, seq_pos, table, active)
        # the table the step read is the host's, as the scheduler left it
        np.testing.assert_array_equal(runner.table.numpy(), eng.kv._table)
        calls[0] += 1
        return out

    eng._decode = checked
    while eng.sched.has_work():
        eng.step()
        assert [t.data_ptr() for t in buffers] == ptrs
        assert eng.kv.pool_ptrs() == pool_ptrs
        assert eng.kv.page_table() is table_dev and table_dev.data_ptr() == table_ptr
        np.testing.assert_array_equal(table_dev.numpy(), eng.kv._table)
    eng._flush_pending()
    reqs = [eng.sched.finished[r] for r in sorted(eng.sched.finished)]
    assert eng.kv.cow_copies >= 1
    assert sum(r.stats.n_preemptions for r in reqs) >= 1
    assert len(reqs) == 5 > ec.max_seqs and calls[0] == eng.decode_steps == runner.calls
    for r, b in zip(reqs, base):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), b)


# --------------------------------------------------------------------------
# (3) deferred tokens do not alias the graph's output buffer
# --------------------------------------------------------------------------

def test_unflushed_greedy_run_equals_one_flushed_every_step():
    """``eos_id`` outside the vocabulary is never sampled but makes the
    engine flush every step; without it the tokens stay on the device until
    the run ends, each step's row copied out of the runner's output."""
    _, tc, _, tp = _setup("dense")
    prompts = _prompts(4, (9, 12, 5), tc.vocab_size)
    flushes = {}
    runs = {}
    for eos in (None, tc.vocab_size):
        ec = EngineConfig(max_seqs=2, max_len=40, page_size=PAGE, eos_id=eos)
        eng = _engine(tc, tp, prompts, ec, 12)
        real = eng._flush_pending
        n = [0]

        def counting(real=real, n=n):
            n[0] += bool(eng._pending)
            real()

        eng._flush_pending = counting
        runs[eos] = [r.out_tokens for r in eng.run()]
        flushes[eos] = n[0]
    assert flushes[None] == 1 and flushes[tc.vocab_size] > 10
    assert runs[None] == runs[tc.vocab_size]
    assert all(len(t) == 12 for t in runs[None])
    assert len({tuple(t) for t in runs[None]}) == 3


# --------------------------------------------------------------------------
# (5) a mesh of several ranks stays eager
# --------------------------------------------------------------------------

def test_engine_on_a_1x2_mesh_does_not_use_the_runner():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_serve_mesh

    _, tc, _, tp = _setup("dense")
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE),
                     mesh=make_serve_mesh("1x2"), device="cpu")
        assert not isinstance(eng._decode, DecodeGraph)
        assert isinstance(Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32,
                                                      page_size=PAGE), device="cpu")._decode,
                          DecodeGraph)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# (6) the launch counters: warm-up and capture kept apart, replays counted
# --------------------------------------------------------------------------

class _Rehearsed(DecodeGraph):
    """The capture path on the CPU: the warm-up calls the step, the
    "capture" calls it once (counting, as a capture counts without
    launching), a "replay" calls nothing."""

    graphed = True

    def _warm_up(self):
        for _ in range(2):
            self._eager()

    def _record(self):
        self.graph = "captured"
        return self._eager()

    def _replay(self):
        pass


def _fake_step(per_call):
    def step(params, pool, tokens, seq_pos, table, active):
        for k in tk.KERNELS:
            k.launches += per_call.get(k.__name__, 0)
        return (torch.zeros(tokens.shape[0], dtype=torch.int32),
                torch.zeros(tokens.shape[0], 1, 5), pool)

    return step


@pytest.mark.parametrize("graphed", [False, True])
def test_launch_counts_of_warm_up_capture_and_replay(monkeypatch, graphed):
    fakes = tuple(types.SimpleNamespace(__name__=n, launches=0) for n in ("decode", "copy"))
    monkeypatch.setattr(tk, "KERNELS", fakes)
    fakes[1].launches = 5  # counts from before the engine existed stay
    per_call = {"decode": 3}
    params, pool = {}, {"seg0": {"attn": {"k": torch.zeros(2)}}}
    cls = _Rehearsed if graphed else DecodeGraph
    runner = cls(_fake_step(per_call), params, pool, 4, 2, "cpu")
    assert tk.launch_counts() == {"decode": 0, "copy": 5}
    assert runner.warmup_launches == {"decode": 3 * (2 if graphed else 1)}
    assert runner.replay_launches == (per_call if graphed else {})
    assert runner.captures == int(graphed)
    for _ in range(4):
        runner(params, pool, torch.zeros(4, 1, dtype=torch.int32), np.zeros(4, np.int32),
               torch.zeros(4, 2, dtype=torch.int32), np.zeros(4, bool))
    assert tk.launch_counts() == {"decode": 12, "copy": 5} and runner.calls == 4
    with pytest.raises(ValueError, match="bound to the weights"):
        runner(params, {"seg0": {"attn": {"k": torch.zeros(2)}}}, None, None, None, None)
    with pytest.raises(ValueError, match="bound to the weights"):
        runner({}, pool, None, None, None, None)


# --------------------------------------------------------------------------
# (7) two runners in one process; the workspaces a runner owns
# --------------------------------------------------------------------------

def test_two_engines_of_different_max_seqs_keep_their_own_buffers():
    """Engine 1 (2 slots) is interrupted by engine 2 (4 slots) and resumes:
    its tokens equal an uninterrupted run's, its buffers keep their storage
    and their sizes."""
    _, tc, _, tp = _setup("dense")
    prompts = _prompts(6, (9, 14, 6), tc.vocab_size)

    def engine(slots):
        return _engine(tc, tp, prompts, EngineConfig(max_seqs=slots, max_len=40,
                                                     page_size=PAGE), 8)

    alone = [r.out_tokens for r in engine(2).run()]
    first = engine(2)
    r1 = first._decode
    ptrs = [t.data_ptr() for t in (r1.tokens, r1.seq_pos, r1.table, r1.active, r1.greedy)]
    for _ in range(4):
        first.step()
    second = engine(4)
    assert second._decode.tokens.shape[0] == 4 and r1.tokens.shape[0] == 2
    second.run()
    got = [r.out_tokens for r in first.run()]
    assert got == alone
    assert [t.data_ptr() for t in (r1.tokens, r1.seq_pos, r1.table, r1.active,
                                   r1.greedy)] == ptrs


def test_owned_workspaces_outlive_a_larger_shared_one():
    """Inside ``own_workspaces`` the paged kernels' partials come from the
    owner's store; a later call outside grows the shared buffer without
    touching the owner's."""
    store = {}
    cpu = torch.device("cpu")
    shared_before = dict(PA._workspaces)
    with PA.own_workspaces(store):
        mine = PA._workspace(cpu, 7, 64)
        assert PA._workspace(cpu, 7, 32) is mine
    assert store == {(cpu, 7): mine} and PA._workspaces == shared_before
    bigger = PA._workspace(cpu, 7, 1024)
    try:
        assert bigger is not mine and store[(cpu, 7)] is mine and mine.numel() == 64
    finally:
        PA._workspaces.pop((cpu, 7))
