"""The chunk step's and the static Server's runners (``serve/graphs.py``) on the CPU.

On the card :class:`ChunkGraph` captures the engine's chunk step once per
chunk shape, and the single-rank ``Server`` captures its prefill once per
prompt shape and its decode step once per wave batch size
(:class:`PrefillGraph`, :class:`StaticDecodeGraph`); on the CPU the same
runners keep the same buffers and copies around eager calls, which these
tests drive (the captures themselves: ``chip_smoke.py`` phase ``graph``,
parts (f) and (g), and ``tests/test_torch_step_graphs_cuda.py``).  Every
runner's step here runs under the CPU sync guard.  At smoke size, fp32,
pages of 8 tokens:

* for dense/GQA, MLA, MoE, SWA, SSM, the hybrid and enc-dec, every chunk
  the runners took inside a served run against the JAX package's compiled
  chunk step, ``repro.serve.engine._prefill_chunk_fn``, on the same weights
  (the JAX package's ``init_params``), the same pool (the port's, copied)
  and the same inputs, its scalars ``jnp.int32``: logits and every pool
  leaf but the null page within 1e-4; and every static decode step of
  ``Server.generate`` against ``_decode_fn`` with ``jnp.int32`` positions,
  logits within 1e-4;
* the chunk step, the static decode step and the prefill on 0-dim device
  scalars run no syncing operation, those families and qwen2-vl;
* the chunk warm-up (rehearsed: the capture path with eager calls) leaves
  every pool leaf but the null page bit for bit, on a pool with live slots;
* the chunk shapes run are a subset of ``chunk_shape_set``, one runner a
  shape;
* over admission, copy-on-write, preemption and refill every runner buffer,
  pool leaf and the page-table mirror keep their storage, and the tokens
  equal ``Server.generate``'s;
* the ``Server``'s reset tree equals a fresh ``init_cache``, every family;
  waves of two batch sizes keep their own trees; the Server keeps at most
  ``MAX_PREFILL_SHAPES`` prefill runners and ``MAX_WAVE_SIZES`` trees;
* an engine and a ``Server`` on a ``1 x 2`` mesh use no runner.
"""
import dataclasses
import functools

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
from repro_torch.analysis.torchcheck.harness import sync_guard
from repro_torch.models import adapters as A
from repro_torch.models import model as TM
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server
from repro_torch.serve.engine import MAX_PREFILL_SHAPES, MAX_WAVE_SIZES, chunk_shape_set
from repro_torch.serve.graphs import ChunkGraph, StaticDecodeGraph, StepGraph
from repro_torch.serve.kvcache import NULL_PAGE

TOL = 1e-4  # logits and pool leaves (the JAX suite's end-to-end tolerance)
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
VISION = ("qwen2-vl-72b", {})

_SETUPS = {}


def _setup(family):
    """The JAX package's weights (seed 0, ``init_params`` jitted: one
    compile, not an eager op a leaf) in both packages, fp32."""
    if family not in _SETUPS:
        arch, over = FAMILIES[family]
        over = {"block": PAGE, **over}
        jc = dataclasses.replace(JC.get_config(arch, smoke=True, dtype=jnp.float32), **over)
        tc = dataclasses.replace(TC.get_config(arch, smoke=True, dtype=torch.float32), **over)
        jp = jax.jit(functools.partial(JM.init_params, jc))(jax.random.PRNGKey(0))
        tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _SETUPS[family] = (jc, tc, jp, tp)
    return _SETUPS[family]


def _torch_only(arch, over):
    cfg = dataclasses.replace(TC.get_config(arch, smoke=True, dtype=torch.float32),
                              block=PAGE, **over)
    return cfg, TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(autouse=True)
def _guarded_steps_and_no_launches(monkeypatch):
    """Every runner's step under the CPU sync guard; no kernel launched."""
    real = StepGraph._eager

    def guarded(self):
        with sync_guard("cpu"):
            return real(self)

    monkeypatch.setattr(StepGraph, "_eager", guarded)
    tk.reset_launch_counts()
    yield
    assert all(n == 0 for n in tk.launch_counts().values()), "a kernel launched on the CPU"


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]


def _audio(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _np_tree(pool):
    return T.tree_map(lambda t: t.numpy().copy(), pool)


def _paged_keys(cfg):
    """(segment, adapter key) of every paged pool: page axis 1, page 0 the
    null page."""
    return {(f"seg{si}", ad.key) for si, (kind, _) in enumerate(A.layer_segments(cfg))
            for ad in A.adapters_for(cfg, kind) if ad.paged}


def _pool_items(cfg, pool):
    """(label, leaf) of every pool leaf, the null page cut from paged ones
    (its content is garbage by design: pad and inactive writes land there)."""
    paged = _paged_keys(cfg)
    for seg, tree in pool.items():
        for key, leaves in tree.items():
            for name, leaf in leaves.items():
                leaf = np.asarray(leaf)
                if (seg, key) in paged:
                    leaf = np.delete(leaf, NULL_PAGE, 1)
                yield f"{seg}/{key}/{name}", leaf


def _record_chunks(eng):
    """Wrap ``eng._chunk``: each call's pool before and after, and the
    inputs the runner took (its buffers, the table row from the mirror)."""
    steps = []
    real = eng._chunk

    def recording(params, pool, toks, slot, off, phys, offs, last):
        before = _np_tree(pool)
        logits, pool = real(params, pool, toks, slot, off, phys, offs, last)
        runner = eng._chunk_graphs[toks.shape[1]]
        s_slot, s_off, s_last = (int(x) for x in runner.scalars)
        steps.append({"pool": before, "after": _np_tree(pool), "n": toks.shape[1],
                      "tokens": runner.tokens.numpy().copy(), "slot": s_slot, "q_off": s_off,
                      "last": s_last, "phys": runner.phys_tok.numpy().copy(),
                      "off": runner.off_tok.numpy().copy(),
                      "row": runner.mirror[s_slot].numpy().copy(),
                      "logits": logits.numpy().copy()})
        assert (s_slot, s_off, s_last) == (slot, off, last)
        return logits, pool

    eng._chunk = recording
    return steps


# --------------------------------------------------------------------------
# (1) chunks and static decode steps against the JAX package's compiled steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_runner_chunks_match_jax_prefill_chunk_fn(family):
    """Two requests (16 and 13 tokens; the second's final chunk ragged)
    through the engine, 4 prompt tokens a step, so chunks of both slots
    interleave; every chunk the runners took, against JAX's jitted chunk."""
    jc, tc, jp, tp = _setup(family)
    eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE,
                                      prefill_tokens_per_step=PAGE), device="cpu")
    audio = _audio(tc, 2) if tc.n_encoder_layers else None
    for i, p in enumerate(_prompts(1, (16, 13), tc.vocab_size)):
        eng.submit(p, 2, rid=i, extras=None if audio is None else
                   {"audio_embeds": audio[i:i + 1]})
    steps = _record_chunks(eng)
    eng.run()
    assert len(steps) == eng.prefill_chunks == 4
    assert {s["slot"] for s in steps} == {0, 1}
    runners = eng._chunk_graphs
    assert set(runners) == {s["n"] for s in steps}
    assert set(runners) <= set(chunk_shape_set(tc, eng.chunk_size))
    assert all(isinstance(r, ChunkGraph) and not r.graphed and r.captures == 0
               for r in runners.values())
    assert sum(r.calls for r in runners.values()) == len(steps)
    chunk = JE._prefill_chunk_fn(jc)
    for i, s in enumerate(steps):
        jl, jpool = chunk(jp, jax.tree.map(jnp.asarray, s["pool"]), jnp.asarray(s["tokens"]),
                          jnp.int32(s["slot"]), jnp.int32(s["q_off"]), jnp.asarray(s["phys"]),
                          jnp.asarray(s["off"]), jnp.asarray(s["row"]), jnp.int32(s["last"]))
        err = float(np.abs(s["logits"] - np.asarray(jl)).max())
        assert err <= TOL, (i, err)
        want = dict(_pool_items(tc, jax.tree.map(np.asarray, jpool)))
        for label, leaf in _pool_items(tc, s["after"]):
            assert float(np.abs(leaf - want[label]).max(initial=0.0)) <= TOL, (i, label)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_server_decode_steps_match_jax_decode_fn(family):
    """A wave of two 11-token prompts, 4 new tokens: each static decode step
    the runner took, against JAX's jitted ``decode_step`` at a
    ``jnp.int32`` position on the same caches."""
    jc, tc, jp, tp = _setup(family)
    srv = Server(tc, tp, ServeConfig(max_len=24), device="cpu")
    batch = {"tokens": np.stack(_prompts(2, (11, 11), tc.vocab_size))}
    if tc.n_encoder_layers:
        batch["audio_embeds"] = _audio(tc, 2)
    steps = []
    real = srv._decode

    def recording(params, caches, tokens, pos):
        before = _np_tree(caches)
        logits, caches = real(params, caches, tokens, pos)
        runner = srv._decode_graphs[tokens.shape[0]]
        steps.append({"caches": before, "tokens": runner.tokens.numpy().copy(),
                      "pos": int(runner.pos), "logits": logits.numpy().copy()})
        return logits, caches

    srv._decode = recording
    out = srv.generate(batch, 4)
    assert out.shape == (2, 4) and [s["pos"] for s in steps] == [11, 12, 13, 14]
    runner = srv._decode_graphs[2]
    assert isinstance(runner, StaticDecodeGraph) and runner.calls == 4 and not runner.graphed
    decode = JE._decode_fn(jc)
    for s in steps:
        jl, _ = decode(jp, jax.tree.map(jnp.asarray, s["caches"]), jnp.asarray(s["tokens"]),
                       jnp.int32(s["pos"]))
        err = float(np.abs(s["logits"] - np.asarray(jl)).max())
        assert err <= TOL, (s["pos"], err)


# --------------------------------------------------------------------------
# (2) no sync on device scalars
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", [*FAMILIES, "vision"])
def test_steps_on_device_scalars_run_no_sync(family):
    """``prefill`` (``last_idx`` a 0-dim tensor where the prompt is
    padded), the static ``decode_step`` (a 0-dim position) and, where the
    engine serves the family, ``prefill_chunk`` (0-dim slot, offset and
    last index), each under the CPU sync guard."""
    cfg, params = _torch_only(*(VISION if family == "vision" else FAMILIES[family]))
    S, B = 10, 2
    s32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    batch = TM.frontend_extras(
        cfg, {"tokens": torch.from_numpy(np.stack(_prompts(3, (S, S), cfg.vocab_size)))},
        B, S, "cpu")
    padded = TM.supports_padded_prefill(cfg)
    with sync_guard("cpu"):
        logits, small = TM.prefill(cfg, params, batch, s32(S - 1) if padded else None)
    caches = TM.init_cache(cfg, B, 16, device="cpu")
    for seg, tree in small.items():
        for key, leaves in tree.items():
            for name, leaf in leaves.items():
                caches[seg][key][name][tuple(slice(0, n) for n in leaf.shape)] = leaf
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    with sync_guard("cpu"):
        step_logits, _ = TM.decode_step(cfg, params, caches, tok, s32(S))
    assert torch.isfinite(step_logits).all()
    if family == "vision":
        return
    pool = TM.init_paged_cache(cfg, 2, 5, PAGE, 32, device="cpu")
    n = 6
    args = (torch.from_numpy(_prompts(4, (n,), cfg.vocab_size)[0][None]), s32(1), s32(8),
            torch.full((n,), 2, dtype=torch.int32), torch.arange(n, dtype=torch.int32),
            torch.tensor([1, 2, 0, 0], dtype=torch.int32), s32(n - 1))
    with sync_guard("cpu"):
        chunk_logits, _ = TM.prefill_chunk(cfg, params, pool, *args)
    assert chunk_logits.shape[:2] == (1, 1) and torch.isfinite(chunk_logits).all()


# --------------------------------------------------------------------------
# (3) the chunk warm-up keeps the pool but its null page
# --------------------------------------------------------------------------

class _Rehearsed(ChunkGraph):
    """The capture path on the CPU: the warm-up calls the step twice, the
    "capture" once (as a capture counts without launching)."""

    graphed = True

    def _warm_up(self):
        for _ in range(2):
            self._eager()

    def _record(self):
        self.graph = "captured"
        return self._eager()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunk_warm_up_keeps_every_pool_leaf_but_the_null_page(family):
    """A pool with live slots -- one decoding, one mid-prefill -- and a
    chunk runner rehearsing its capture at the mid-prefill slot's next
    chunk: no bit of any pool leaf changes outside the null page."""
    _, tc, _, tp = _setup(family)
    ec = EngineConfig(max_seqs=2, max_len=40, page_size=PAGE, prefill_tokens_per_step=PAGE)
    eng = Engine(tc, tp, ec, device="cpu")
    audio = _audio(tc, 2) if tc.n_encoder_layers else None
    for i, p in enumerate(_prompts(2, (10, 20), tc.vocab_size)):
        eng.submit(p, 6, rid=i, extras=None if audio is None else
                   {"audio_embeds": audio[i:i + 1]})
    while not (eng.decode_steps and eng.sched.prefilling):
        eng.step()
    slot, req = eng.sched.prefilling[0]
    assert req.prefill_pos > 0
    before = _np_tree(eng.kv.data)
    rows = eng.kv.slot_row_leaves()
    assert all(np.any(leaf[:, slot].numpy()) for leaf in rows)
    runner = _Rehearsed(eng._chunk_fn, eng.params, eng.kv.data, eng.kv.page_table(), PAGE,
                        "cpu", slot_rows=rows)
    runner.tokens.copy_(torch.from_numpy(req.effective_prompt[None, req.prefill_pos:
                                                               req.prefill_pos + PAGE]))
    runner.scalars.copy_(torch.tensor([slot, req.prefill_pos, PAGE - 1]))
    runner._capture()
    assert runner.captures == 1 and not runner.phys_tok.any()
    want = dict(_pool_items(tc, before))
    for label, leaf in _pool_items(tc, _np_tree(eng.kv.data)):
        np.testing.assert_array_equal(leaf, want[label], err_msg=label)


# --------------------------------------------------------------------------
# (4) stable storages over admission, COW, preemption and refill
# --------------------------------------------------------------------------

def test_buffers_keep_their_storage_through_cow_preemption_and_refill():
    """Five prompts just under a page boundary, the second the first's
    prefix (its shared tail page copies on write), on 4 slots and 8 usable
    pages of 4 tokens (growth preempts; preempted requests re-run their
    chunks): every runner's buffers, the pool and the mirror stay put."""
    _, tc, _, tp = _setup("dense")
    prompts = _prompts(21, (11, 6, 11, 7, 8), tc.vocab_size)
    prompts[1] = prompts[0][:6].copy()
    max_new = 12
    srv = Server(tc, tp, ServeConfig(max_len=64), device="cpu")
    base = [srv.generate({"tokens": p[None]}, max_new)[0] for p in prompts]
    ec = EngineConfig(max_seqs=4, max_len=24, page_size=4, num_pages=9)
    eng = Engine(tc, tp, ec, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, rid=i, arrival_step=2 * i)
    pool_ptrs = eng.kv.pool_ptrs()
    mirror = eng.kv.page_table()
    held = {}

    def ptrs():
        return {n: [t.data_ptr() for t in (r.tokens, r.phys_tok, r.off_tok, r.scalars)]
                for n, r in eng._chunk_graphs.items()}

    while eng.sched.has_work():
        eng.step()
        now = ptrs()
        assert {n: p for n, p in now.items() if n in held} == held
        held = now
        assert eng.kv.pool_ptrs() == pool_ptrs
        assert eng.kv.page_table() is mirror and eng._decode.table is mirror
    eng._flush_pending()
    reqs = [eng.sched.finished[r] for r in sorted(eng.sched.finished)]
    assert eng.kv.cow_copies >= 1
    assert sum(r.stats.n_preemptions for r in reqs) >= 1
    assert sum(r.calls for r in eng._chunk_graphs.values()) == eng.prefill_chunks
    for r, b in zip(reqs, base):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), b)


# --------------------------------------------------------------------------
# (5) the Server's cache trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", [*FAMILIES, "vision"])
def test_server_reset_tree_equals_a_fresh_init_cache(family):
    cfg, params = _torch_only(*(VISION if family == "vision" else FAMILIES[family]))
    srv = Server(cfg, params, ServeConfig(max_len=20), device="cpu")
    srv.generate({"tokens": np.stack(_prompts(5, (10, 10), cfg.vocab_size))}, 3)
    tree = srv._caches[2]
    assert any(np.any(leaf.numpy()) for leaf in T.leaves(tree))
    assert srv._wave_cache(2) is tree
    fresh = TM.init_cache(cfg, 2, 20, device="cpu")
    assert T.tree_map(lambda t: (tuple(t.shape), t.dtype), tree) == T.tree_map(
        lambda t: (tuple(t.shape), t.dtype), fresh)
    for got, want in zip(T.leaves(tree), T.leaves(fresh)):
        assert torch.equal(got, want)


def test_waves_of_two_batch_sizes_keep_their_own_trees():
    """B = 2, then B = 1, then B = 2 again: one tree and one decode runner a
    batch size, each bound to its own tree; the tokens equal a fresh
    Server's for each wave."""
    _, tc, _, tp = _setup("dense")
    two = {"tokens": np.stack(_prompts(6, (9, 9), tc.vocab_size))}
    one = {"tokens": _prompts(7, (12,), tc.vocab_size)[0][None]}
    srv = Server(tc, tp, ServeConfig(max_len=24), device="cpu")
    first = srv.generate(two, 5)
    ptrs = [t.data_ptr() for t in T.leaves(srv._caches[2])]
    got_one = srv.generate(one, 5)
    again = srv.generate(two, 5)
    assert set(srv._caches) == set(srv._decode_graphs) == {1, 2}
    for b in (1, 2):
        bound = srv._decode_graphs[b]._cache_leaves
        assert all(a is c for a, c in zip(bound, T.leaves(srv._caches[b])))
        assert T.leaves(srv._caches[b])[0].shape[1] == b
    assert [t.data_ptr() for t in T.leaves(srv._caches[2])] == ptrs
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(
        got_one, Server(tc, tp, ServeConfig(max_len=24), device="cpu").generate(one, 5))
    assert srv._decode_graphs[2].calls == 10 and srv._decode_graphs[1].calls == 5


def test_server_keeps_a_bounded_number_of_runners_and_trees():
    """The SWA ring prefills at the prompt's exact length: three more
    lengths than ``MAX_PREFILL_SHAPES`` leave that many prefill runners,
    the oldest lengths dropped; one more batch size than ``MAX_WAVE_SIZES``
    drops the least recently used size's tree and every runner bound to
    it; a wave of a dropped size then equals a fresh Server's."""
    cfg, params = _torch_only(*FAMILIES["swa"])
    srv = Server(cfg, params, ServeConfig(max_len=40), device="cpu")
    lengths = list(range(4, 4 + MAX_PREFILL_SHAPES + 3))
    for n in lengths:
        srv.generate({"tokens": _prompts(n, (n,), cfg.vocab_size)[0][None]}, 1)
    kept = [dict((k, shape) for k, shape, _ in key[1])["tokens"][1]
            for key in srv._prefill_graphs]
    assert kept == lengths[-MAX_PREFILL_SHAPES:]
    for b in range(2, MAX_WAVE_SIZES + 2):
        srv.generate({"tokens": np.stack(_prompts(b, (6,) * b, cfg.vocab_size))}, 1)
    assert list(srv._caches) == list(range(2, MAX_WAVE_SIZES + 2))
    assert set(srv._decode_graphs) == set(srv._caches)
    assert {key[0] for key in srv._prefill_graphs} == set(srv._caches)
    for key, runner in srv._prefill_graphs.items():
        assert all(a is b for a, b in zip(runner._cache_leaves, T.leaves(srv._caches[key[0]])))
    one = {"tokens": _prompts(30, (7,), cfg.vocab_size)[0][None]}
    np.testing.assert_array_equal(
        srv.generate(one, 3), Server(cfg, params, ServeConfig(max_len=40),
                                     device="cpu").generate(one, 3))
    assert 1 in srv._caches and 2 not in srv._caches


# --------------------------------------------------------------------------
# (6) a mesh of several ranks stays eager
# --------------------------------------------------------------------------

def test_engine_and_server_on_a_1x2_mesh_use_no_runner():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_serve_mesh

    _, tc, _, tp = _setup("dense")
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = make_serve_mesh("1x2")
        eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE),
                     mesh=mesh, device="cpu")
        srv = Server(tc, tp, ServeConfig(max_len=24), mesh=mesh, device="cpu")
        assert eng._chunk_graphs is None and not srv._graphs
        single = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE),
                        device="cpu")
        assert single._chunk_graphs == {} and Server(tc, tp, ServeConfig(max_len=24),
                                                     device="cpu")._graphs
    finally:
        dist.destroy_process_group()
