"""The port's Mamba-2 SSD block, its state rows and the SSM and hybrid
stacks against the JAX package's, on the CPU, at smoke size.

Both packages run the JAX package's weights (``ssm_init`` / ``init_params``),
carried over with ``params_from_numpy``, on inputs from a numpy seed:

* ``ssm_forward`` in fp32 within 1e-5 (two groups of heads over 24 tokens;
  mamba2 smoke over 19 tokens, a ragged remainder chunk) and in bf16
  within 2e-2; ``ssm_step`` from a random state within 1e-5;
  ``ssm_reference`` against the chunked path within the JAX suite's 3e-4;
* a prefill in two grid-aligned pieces equals the one-shot prefill bit
  for bit in the port;
* ``SSMStateAdapter``: a dirty row is zeroed by the first chunk, and an
  inactive slot's rows stay bit for bit through ``decode``;
* mamba2 and hymba logits within 1e-4: prefill then 4 decode steps, and
  the engine's chunk and paged-decode steps;
* the port's engine against its own ``Server.generate``, token for token,
  chunked and unchunked, with prompts that straddle the chunk grid;
* the chunk grid and the sharing rules.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as JC
import repro_torch.configs as TC
import repro_torch.kernels as tk
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import adapters as A
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server

TOL = 1e-4  # logits (ROADMAP.md)
MODULE_TOL = 1e-5
BF16_TOL = 2e-2
PAGE = 8
ARCHS = ("mamba2-130m", "hymba-1.5b")


def _cfgs(arch, **over):
    over = {"block": PAGE, **over}
    jc = dataclasses.replace(JC.get_config(arch, smoke=True, dtype=jnp.float32), **over)
    tc = dataclasses.replace(TC.get_config(arch, smoke=True, dtype=torch.float32), **over)
    return jc, tc


_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        jc, tc = _cfgs(arch)
        jp = JM.init_params(jc, jax.random.PRNGKey(0))
        tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _SETUPS[arch] = (jc, tc, jp, tp)
    return _SETUPS[arch]


@pytest.fixture(autouse=True)
def _no_launches_on_the_cpu():
    tk.reset_launch_counts()
    yield
    assert all(n == 0 for n in tk.launch_counts().values()), "a kernel launched on the CPU"


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(a, b, tol=TOL):
    err = float(np.abs(_np(a) - _np(b)).max())
    assert err <= tol, err


def _x(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _grouped_cfgs():
    """tests/test_models.py's SSD config: two groups of heads."""
    kw = dict(name="t", family="ssm", n_layers=1, d_model=32, n_heads=0, n_kv_heads=0,
              d_head=0, d_ff=0, vocab_size=16, ssm_state=16, ssm_headdim=8, ssm_expand=2,
              ssm_ngroups=2, ssm_chunk=8)
    return JModelConfig(dtype=jnp.float32, **kw), TModelConfig(dtype=torch.float32, **kw)


def _ssm_params(jc, seed=0):
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), jc)
    # non-trivial biases and skip weights, so every parameter shows in the output
    rng = np.random.default_rng(seed + 100)
    H = jc.ssm_nheads
    jp["dt_bias"] = jnp.asarray(_x(rng, H, scale=0.5))
    jp["D"] = jnp.asarray(1.0 + _x(rng, H, scale=0.1))
    jp["conv_b"] = jnp.asarray(_x(rng, *jp["conv_b"].shape, scale=0.1)).astype(jc.dtype)
    return jp, TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# --------------------------------------------------------------------------
# The SSD block against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ngroups2-S24", "mamba2-smoke-S19"])
def test_ssm_forward_matches_jax(case):
    """Prefill from no state and from a carried state: output, final state
    and conv history within 1e-5 (S = 19 over chunks of 8 leaves a ragged
    remainder; the grouped config maps head h to group h // 4)."""
    if case == "ngroups2-S24":
        (jc, tc), S = _grouped_cfgs(), 24
    else:
        (jc, tc), S = _cfgs("mamba2-130m"), 19
    jp, tp = _ssm_params(jc)
    rng = np.random.default_rng(S)
    x = _x(rng, 2, S, tc.d_model, scale=0.5)
    jout, jst = jssm.ssm_forward(jp, jc, jnp.asarray(x), mode="prefill")
    tout, tst = tssm.ssm_forward(tp, tc, torch.from_numpy(x), mode="prefill")
    _close(tout, jout, MODULE_TOL)
    assert tst["state"].dtype == torch.float32 and tst["conv"].dtype == tc.dtype
    for name in ("state", "conv"):
        _close(tst[name], jst[name], MODULE_TOL)
    # a second piece from the carried state
    x2 = _x(rng, 2, 11, tc.d_model, scale=0.5)
    jout, jst = jssm.ssm_forward(jp, jc, jnp.asarray(x2), mode="prefill", state=jst)
    tout, tst = tssm.ssm_forward(tp, tc, torch.from_numpy(x2), mode="prefill", state=tst)
    _close(tout, jout, MODULE_TOL)
    _close(tst["state"], jst["state"], MODULE_TOL)


def test_ssm_forward_bf16_matches_jax():
    jc, tc = _cfgs("mamba2-130m", dtype=None)
    jc = dataclasses.replace(jc, dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    jp, tp = _ssm_params(jc, seed=3)
    assert tp["A_log"].dtype == torch.float32 and tp["in_proj"].dtype == torch.bfloat16
    x = _x(np.random.default_rng(5), 2, 21, tc.d_model, scale=0.5)
    jout, jst = jssm.ssm_forward(jp, jc, jnp.asarray(x, jnp.bfloat16), mode="prefill")
    tout, tst = tssm.ssm_forward(tp, tc, torch.from_numpy(x).bfloat16(), mode="prefill")
    assert tout.dtype == torch.bfloat16 and tst["conv"].dtype == torch.bfloat16
    _close(tout, jout, BF16_TOL)
    _close(tst["state"], jst["state"], BF16_TOL)


def test_ssm_step_matches_jax():
    """One decode step from a random state and conv history."""
    jc, tc = _grouped_cfgs()
    jp, tp = _ssm_params(jc, seed=1)
    rng = np.random.default_rng(11)
    st = tssm.ssm_state_init(tc, 3)
    state = {k: _x(rng, *v.shape, scale=0.3) for k, v in st.items()}
    x = _x(rng, 3, 1, tc.d_model)
    jout, jst = jssm.ssm_step(jp, jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    before = {k: v.clone() for k, v in tstate.items()}
    tout, tst = tssm.ssm_step(tp, tc, torch.from_numpy(x), tstate)
    _close(tout, jout, MODULE_TOL)
    for name in ("state", "conv"):
        _close(tst[name], jst[name], MODULE_TOL)
        assert torch.equal(tstate[name], before[name])  # read, never written


def test_ssm_reference_matches_chunked_path():
    jc, tc = _grouped_cfgs()
    jp, tp = _ssm_params(jc)
    x = _x(np.random.default_rng(1), 2, 24, tc.d_model, scale=0.5)
    y_chunk, _ = tssm.ssm_forward(tp, tc, torch.from_numpy(x))
    y_ref = tssm.ssm_reference(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(y_chunk.numpy(), y_ref.numpy(), rtol=3e-4, atol=3e-4)
    _close(y_ref, jssm.ssm_reference(jp, jc, jnp.asarray(x)), MODULE_TOL)


def test_grid_aligned_pieces_equal_one_shot_prefill_bit_for_bit():
    """27 tokens as 16 + 11 (boundaries on the grid of 8) run the one-shot
    prefill's per-chunk ops: equal outputs, state and conv history."""
    jc, tc = _cfgs("mamba2-130m")
    _, tp = _ssm_params(jc)
    x = torch.from_numpy(_x(np.random.default_rng(2), 1, 27, tc.d_model, scale=0.5))
    one, st1 = tssm.ssm_forward(tp, tc, x, mode="prefill")
    a, st = tssm.ssm_forward(tp, tc, x[:, :16], mode="prefill")
    b, st = tssm.ssm_forward(tp, tc, x[:, 16:], mode="prefill", state=st)
    assert torch.equal(torch.cat([a, b], dim=1), one)
    for name in ("state", "conv"):
        assert torch.equal(st[name], st1[name]), name


# --------------------------------------------------------------------------
# SSMStateAdapter
# --------------------------------------------------------------------------

def _pool(tc, max_seqs=3):
    geom = A.CacheGeometry(max_seqs=max_seqs, num_pages=5, page_size=PAGE, max_len=32)
    return A.SSM_STATE.init_pool(tc, geom, device="cpu")


def test_ssm_adapter_first_chunk_zeroes_a_dirty_row():
    """A re-used slot's first chunk computes what a fresh pool computes;
    the other slots' rows are untouched."""
    jc, tc = _cfgs("mamba2-130m")
    _, tp = _ssm_params(jc)
    rng = np.random.default_rng(3)
    dirty = _pool(tc)
    for t in dirty.values():
        t.copy_(torch.from_numpy(_x(rng, *t.shape)))
    other = {k: v[0].clone() for k, v in dirty.items()}
    x = torch.from_numpy(_x(rng, 1, 8, tc.d_model))
    ctx = {"slot": 1, "first": True}
    used, _ = A.SSM_STATE.chunk(tp, tc, x, None, dirty, ctx, 0)
    fresh = _pool(tc)
    want, _ = A.SSM_STATE.chunk(tp, tc, x, None, fresh, ctx, 0)
    assert torch.equal(used, want)
    for name in ("state", "conv"):
        assert torch.equal(dirty[name][1], fresh[name][1]), name
        assert torch.equal(dirty[name][0], other[name]), name
    # a later chunk carries the row on
    x2 = torch.from_numpy(_x(rng, 1, 5, tc.d_model))
    got, _ = A.SSM_STATE.chunk(tp, tc, x2, None, dirty, {"slot": 1, "first": False}, 8)
    one, _ = tssm.ssm_forward(tp, tc, torch.cat([x, x2], dim=1), mode="prefill")
    assert torch.equal(got, one[:, 8:])


def test_ssm_adapter_decode_keeps_inactive_rows_bit_for_bit():
    jc, tc = _cfgs("mamba2-130m")
    jp, tp = _ssm_params(jc)
    rng = np.random.default_rng(4)
    pool = _pool(tc)
    for t in pool.values():
        t.copy_(torch.from_numpy(_x(rng, *t.shape, scale=0.3)))
    jpool = {k: jnp.asarray(v.numpy().copy()) for k, v in pool.items()}  # no shared buffer
    before = {k: v[1].clone() for k, v in pool.items()}
    x = _x(rng, 3, 1, tc.d_model)
    active = np.array([True, False, True])
    tout, same = A.SSM_STATE.decode(tp, tc, torch.from_numpy(x), None, pool, seq_pos=None,
                                    page_table=None, active=torch.from_numpy(active))
    assert same is pool
    jout, jnew = jssm.ssm_step(jp, jc, jnp.asarray(x), jpool)
    _close(tout[active], np.asarray(jout)[active], MODULE_TOL)
    for name in ("state", "conv"):
        assert torch.equal(pool[name][1], before[name]), name
        _close(pool[name][active], np.asarray(jnew[name])[active], MODULE_TOL)


# --------------------------------------------------------------------------
# Model logits against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    jc, tc, jp, tp = _setup(arch)
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, size=(2, 13)).astype(np.int32)
    S, max_len = toks.shape[1], 24
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = TM.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jfull = jax.tree.map(
        lambda small, big: jax.lax.dynamic_update_slice(big, small.astype(big.dtype),
                                                        (0,) * big.ndim),
        jcache, JM.init_cache(jc, 2, max_len))
    tfull = Server(tc, tp, ServeConfig(max_len=max_len), device="cpu")._grow_cache(tcache, 2, S)
    for i in range(4):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jfull = JM.decode_step(jc, jp, jfull, jnp.asarray(nxt), jnp.int32(S + i))
        tl, tfull = TM.decode_step(tc, tp, tfull, torch.from_numpy(nxt), S + i)
        _close(tl, jl)
    _close(tfull["seg0"]["ssm"]["state"], jfull["seg0"]["ssm"]["state"], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_and_paged_decode_logits_match_jax(arch):
    """Slot 0 prefills 13 tokens in two grid-aligned chunks, slot 1 six;
    then one lockstep decode of both slots."""
    jc, tc, jp, tp = _setup(arch)
    maxp, num_pages = 3, 7
    table = np.array([[3, 5, 6], [2, 0, 0]], np.int32)
    rng = np.random.default_rng(4)
    p0, p1 = (rng.integers(0, tc.vocab_size, size=(n,)).astype(np.int32) for n in (13, 6))
    jcache = JM.init_paged_cache(jc, 2, num_pages, PAGE, maxp * PAGE)
    tcache = TM.init_paged_cache(tc, 2, num_pages, PAGE, maxp * PAGE, device="cpu")
    assert set(tcache["seg0"]) == set(jcache["seg0"])
    for slot, prompt, start, n in ((0, p0, 0, 8), (0, p0, 8, 5), (1, p1, 0, 6)):
        toks = prompt[None, start:start + n]
        pos = np.arange(start, start + n)
        phys = table[slot][pos // PAGE].astype(np.int32)
        off = (pos % PAGE).astype(np.int32)
        jl, jcache = JM.prefill_chunk(jc, jp, jcache, jnp.asarray(toks), slot, start,
                                      jnp.asarray(phys), jnp.asarray(off),
                                      jnp.asarray(table[slot]), n - 1)
        tl, tcache = TM.prefill_chunk(tc, tp, tcache, torch.from_numpy(toks), slot, start,
                                      torch.from_numpy(phys), torch.from_numpy(off),
                                      torch.from_numpy(table[slot]), n - 1)
        _close(tl, jl)
    nxt, seq = np.array([[7], [9]], np.int32), np.array([13, 6], np.int32)
    jl, jcache = JM.decode_step_paged(jc, jp, jcache, jnp.asarray(nxt), jnp.asarray(seq),
                                      jnp.asarray(table), jnp.asarray([True, True]))
    tl, tcache = TM.decode_step_paged(tc, tp, tcache, torch.from_numpy(nxt),
                                      torch.from_numpy(seq), torch.from_numpy(table),
                                      torch.tensor([True, True]))
    _close(tl, jl)
    _close(tcache["seg0"]["ssm"]["state"], jcache["seg0"]["ssm"]["state"], 1e-4)


# --------------------------------------------------------------------------
# The registry and the engine against its own generate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_grid_and_sharing_rules(arch):
    jc, tc = _cfgs(arch)
    assert A.unsupported_reason(tc) is None
    assert A.prefill_chunk_multiple(tc) == tc.ssm_chunk
    full = TC.get_config(arch)
    assert A.prefill_chunk_multiple(full) == 128  # lcm(ring 1, ssm_chunk 128)
    from repro.models import adapters as JA

    for cfg, jcfg in ((tc, jc), (full, JC.get_config(arch))):
        assert (A.prefix_shareable(cfg), A.prefix_compute_skippable(cfg)) == (False, False)
        assert A.prefix_shareable(cfg) == JA.prefix_shareable(jcfg)
        assert [ad.key for ad in A.all_adapters(cfg)] == [ad.key for ad in JA.all_adapters(jcfg)]
    assert A.SSM_STATE.family in A.supported_families() and not A.SSM_STATE.paged


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_own_generate(arch, chunked):
    """4 requests through 2 slots (slot re-fills), prompts of 5, 16, 19 and
    27 tokens straddling the grid of 8: tokens equal generate exactly."""
    _, tc, _, tp = _setup(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tc.vocab_size, size=(n,)).astype(np.int32)
               for n in (5, 16, 19, 27)]
    srv = Server(tc, tp, ServeConfig(max_len=40), device="cpu")
    base = [srv.generate({"tokens": p[None]}, 6)[0] for p in prompts]
    eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=40, page_size=PAGE,
                                      chunked_prefill=chunked, debug_audit=True), device="cpu")
    assert eng.chunk_size == PAGE and not eng.kv.sharing
    for i, p in enumerate(prompts):
        eng.submit(p, 6, rid=i, arrival_step=i)
    reqs = eng.run()
    for r, b in zip(reqs, base):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), b)
    if chunked:
        assert eng.prefill_chunks == sum(-(-len(p) // PAGE) for p in prompts)
    assert not eng.kv.audit().slot_held
