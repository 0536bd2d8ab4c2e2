"""The port's MoE (token-choice top-k with capacity dispatch) against the JAX
package's, on the CPU, at smoke widths.

Configurations: the ``granite-moe-3b-a800m`` smoke config (GQA over 8
experts, top-2, no shared expert) and the ``deepseek-v3-671b`` smoke config
(MLA, 1 dense + 1 MoE layer, 4 experts top-2 plus a shared one, an MTP
head).  Both packages run the JAX package's ``init_params`` / ``moe_init``
weights, carried over with ``params_from_numpy``, on inputs from a numpy
seed:

* ``moe_forward`` -- outputs and the auxiliary loss within 1e-5 in fp32,
  including a forced-drop case (near-identical tokens on one hot expert at
  ``capacity_factor=1.0``, as ``tests/test_serve.py`` builds it), where the
  drop pattern must match; the same case in bf16 within 2e-2; the capacity
  ``Cg`` at ``Tg*k*cf/E`` just above and below multiples of 8; a 4-slot
  decode that drops nothing at granite's and DeepSeek-V3's expert counts;
* the models' prefill, decode, paged chunk and paged decode logits within
  1e-4, through both decode backends;
* the port's engine against its own ``Server.generate``, token for token,
  where the JAX package's engine is exact too: single-chunk prompts, and
  ``chunked_prefill=False`` with multi-page prompts; and prefix sharing,
  which a MoE stack uses for memory only (it recomputes every chunk).

The JAX engine's tokens are not a target (ROADMAP.md lists its MoE engine
tests among those that fail under xdist).
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
from repro.models import ffn as jffn
from repro.models import model as JM
from repro_torch.models import adapters as A
from repro_torch.models import ffn as tffn
from repro_torch.models import model as TM
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server

ARCHS = ["granite-moe-3b-a800m", "deepseek-v3-671b"]
TOL = 1e-4
MOE_TOL = 1e-5
BF16_TOL = 2e-2
PAGE = 8


def _cfgs(arch, jdtype=jnp.float32, tdtype=torch.float32, **over):
    over = {"block": PAGE, **over}
    jc = dataclasses.replace(JC.get_config(arch, smoke=True, dtype=jdtype), **over)
    tc = dataclasses.replace(TC.get_config(arch, smoke=True, dtype=tdtype), **over)
    return jc, tc


_SETUPS = {}


def _setup(arch):
    """The JAX package's weights for ``arch`` (seed 0), in both packages."""
    if arch not in _SETUPS:
        jc, tc = _cfgs(arch)
        jp = JM.init_params(jc, jax.random.PRNGKey(0))
        _SETUPS[arch] = (jc, tc, jp, TM.params_from_numpy(jax.tree.map(np.asarray, jp),
                                                          device="cpu"))
    return _SETUPS[arch]


@pytest.fixture(autouse=True)
def _no_launches_on_the_cpu():
    tk.reset_launch_counts()
    yield
    assert all(n == 0 for n in tk.launch_counts().values()), "a kernel launched on the CPU"


def _close(a, b, tol=TOL):
    err = float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())
    assert err <= tol, err


def _tokens(seed, *shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _to_port(tree):
    return TM.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# --------------------------------------------------------------------------
# moe_forward against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch):
    jc, tc = _cfgs(arch)
    jp = jffn.moe_init(jax.random.PRNGKey(3), jc)
    x = np.random.default_rng(0).standard_normal((2, 11, tc.d_model)).astype(np.float32)
    jout, jaux = jffn.moe_forward(jp, jc, jnp.asarray(x))
    tout, taux = tffn.moe_forward(_to_port(jp), tc, torch.from_numpy(x))
    assert tuple(tout.shape) == jout.shape and tout.dtype == torch.float32
    _close(tout, jout, MOE_TOL)
    _close(taux, jaux, MOE_TOL)


def _forced_drop(jdtype):
    """16 near-identical tokens on one hot expert at capacity_factor 1.0:
    Cg = 8, so the one-shot dispatch drops the hot expert for 8 of them
    (``tests/test_serve.py``'s regroup case)."""
    jc, tc = _cfgs("granite-moe-3b-a800m", jdtype,
                   torch.float32 if jdtype == jnp.float32 else torch.bfloat16,
                   capacity_factor=1.0)
    jp = jffn.moe_init(jax.random.PRNGKey(0), jc)
    base = jax.random.normal(jax.random.PRNGKey(1), (jc.d_model,), jnp.float32)
    noise = jax.random.normal(jax.random.PRNGKey(2), (1, 16, jc.d_model), jnp.float32)
    x = (jnp.broadcast_to(base, (1, 16, jc.d_model)) + 1e-2 * noise).astype(jdtype)
    logits = np.asarray(x[0].astype(jnp.float32) @ jp["router"])
    top1 = logits.argmax(-1)
    assert (top1 == top1[0]).all(), "setup: tokens must share a hot expert"
    assert tffn.moe_capacity(16, tc) == 8  # 16 tokens on one expert: 8 overflow
    return jc, tc, jp, x


def test_moe_forward_forced_drop_matches_jax():
    """The drop pattern matches: outputs and aux within 1e-5, and the
    dropped tokens (8..15) differ from what the two 8-token halves give,
    in both packages alike."""
    jc, tc, jp, x = _forced_drop(jnp.float32)
    tp, tx = _to_port(jp), torch.from_numpy(np.array(x))
    jout, jaux = jffn.moe_forward(jp, jc, x)
    tout, taux = tffn.moe_forward(tp, tc, tx)
    _close(tout, jout, MOE_TOL)
    _close(taux, jaux, MOE_TOL)
    halves = torch.cat([tffn.moe_forward(tp, tc, tx[:, :8])[0],
                        tffn.moe_forward(tp, tc, tx[:, 8:])[0]], dim=1)
    assert torch.equal(halves[:, :8], tout[:, :8])  # within capacity: same dispatch
    dropped = (halves[:, 8:] - tout[:, 8:]).abs().amax(-1)[0]
    assert bool((dropped > 1e-3).all()), dropped  # past capacity: the hot expert dropped


def test_moe_forward_forced_drop_bf16_matches_jax():
    jc, tc, jp, x = _forced_drop(jnp.bfloat16)
    tp = _to_port(jp)
    assert tp["router"].dtype == torch.float32 and tp["w_up"].dtype == torch.bfloat16
    tx = TM.params_from_numpy({"x": np.asarray(x)}, device="cpu")["x"]
    jout, jaux = jffn.moe_forward(jp, jc, x)
    tout, taux = tffn.moe_forward(tp, tc, tx)
    assert tout.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    _close(_np(tout), _np(jout), BF16_TOL)
    _close(_np(taux), _np(jaux), BF16_TOL)


# Tg * k * cf / E just below, at and just above multiples of 8: int()
# truncates before the round-up, and Cg is never below 8.
@pytest.mark.parametrize("tokens,k,cf,experts,want", [
    (64, 2, 1.0, 8, 16),       # 16.0 exactly
    (65, 2, 1.0, 8, 16),       # 16.25 truncates to 16: no round-up to 24
    (63, 2, 1.0, 8, 16),       # 15.75 truncates to 15, rounds up to 16
    (68, 2, 1.0, 8, 24),       # 17.0 rounds up to 24
    (128, 8, 1.25, 40, 32),    # granite, a 128-token chunk: 32.0
    (127, 8, 1.25, 40, 32),    # 31.75 -> 31 -> 32
    (129, 8, 1.25, 40, 32),    # 32.25 -> 32
    (4, 8, 1.25, 40, 8),       # a 4-slot decode: 1.0 -> the floor of 8
    (25, 8, 1.25, 40, 8),      # 6.25 -> 6 -> the floor of 8
    (1500, 8, 1.25, 256, 64),  # DeepSeek-V3, a 1500-token prompt: 58.59 -> 64
])
def test_moe_capacity_truncates_then_rounds_up_to_8(tokens, k, cf, experts, want):
    cfg = dataclasses.replace(TC.get_config("granite-moe-3b-a800m", smoke=True),
                              top_k=k, capacity_factor=cf, n_experts=experts)
    # the JAX package's expression (src/repro/models/ffn.py, moe_forward)
    assert max(8, -(-int(tokens * k * cf / experts) // 8) * 8) == want
    assert tffn.moe_capacity(tokens, cfg) == want


def _dense_moe(p, cfg, x):
    """Every token through its own top-k experts, no capacity: the MoE's
    math without the dispatch."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf.float() @ p["router"], -1)
    gates, idx = torch.topk(probs, cfg.top_k, -1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for g, e in zip(gates[t], idx[t]):
            h = torch.nn.functional.silu(xf[t] @ p["w_gate"][e]) * (xf[t] @ p["w_up"][e])
            out[t] += g * (h @ p["w_down"][e])
    if cfg.n_shared_experts:
        out = out + tffn.ffn_forward(p["shared"], cfg, xf)
    return out.reshape(x.shape)


@pytest.mark.parametrize("arch,experts", [("granite-moe-3b-a800m", 40),
                                          ("deepseek-v3-671b", 256)])
def test_four_slot_decode_drops_nothing(arch, experts):
    """A lockstep decode of 4 slots (idle ones included: they route a token
    too) is 4 tokens of top-8 over the full model's expert count: Cg = 8
    holds every choice, so the dispatch equals the capacity-free sum."""
    _, tc = _cfgs(arch, n_experts=experts, top_k=8)
    p = tffn.moe_init(torch.Generator().manual_seed(0), tc, device="cpu")
    x = torch.randn(4, 1, tc.d_model, generator=torch.Generator().manual_seed(1))
    x[2:] = 0.0  # two idle slots (their hidden states are whatever token 0 gives)
    assert tffn.moe_capacity(4, tc) == 8
    out, _ = tffn.moe_forward(p, tc, x)
    want = _dense_moe(p, tc, x)
    assert float((out - want).abs().max()) <= MOE_TOL


# --------------------------------------------------------------------------
# Parameters and the registry
# --------------------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_moe_trees(arch):
    """A bf16 tree: the router stays fp32, the experts bf16; DeepSeek-V3's
    ``mtp`` subtree is carried (training reads it).  The port's own
    ``init_params`` draws the same keys and shapes, the MTP head included."""
    jc, tc = _cfgs(arch, jnp.bfloat16, torch.bfloat16)
    jp = jax.tree.map(np.asarray, JM.init_params(jc, jax.random.PRNGKey(0)))
    tp = TM.params_from_numpy(jp, device="cpu")
    moe_seg = f"seg{len(A.layer_segments(tc)) - 1}"
    moe = tp[moe_seg]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == moe["w_down"].dtype == torch.bfloat16
    n_moe = tc.n_layers - tc.first_k_dense
    assert tuple(moe["w_gate"].shape) == (n_moe, tc.n_experts, tc.d_model, tc.moe_d_ff)
    np.testing.assert_array_equal(moe["router"].numpy(), jp[moe_seg]["moe"]["router"])
    assert ("mtp" in tp) == bool(tc.mtp_depth) == ("mtp" in jp)
    if tc.mtp_depth:
        assert _shapes(tp["mtp"]) == _shapes(jp["mtp"])
    own = TM.init_params(tc, device="cpu")
    assert _shapes(own) == _shapes(jp)  # the MTP head drawn too
    assert own[moe_seg]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch,adapter", [("granite-moe-3b-a800m", "PAGED_GQA"),
                                          ("deepseek-v3-671b", "MLA_LATENT")])
def test_moe_families_are_served_with_their_attention_adapter(arch, adapter):
    _, tc = _cfgs(arch)
    assert A.unsupported_reason(tc) is None
    want = getattr(A, adapter)
    assert [A.adapters_for(tc, kind) for kind, _ in A.layer_segments(tc)] == \
        [[want]] * len(A.layer_segments(tc))
    # a MoE stack aliases full pages and recomputes every chunk
    assert A.prefix_shareable(tc) and not A.prefix_compute_skippable(tc)


# --------------------------------------------------------------------------
# Model logits against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    jc, tc, jp, tp = _setup(arch)
    toks = _tokens(2, 2, 9, vocab=tc.vocab_size)
    S, max_len = toks.shape[1], 16
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = TM.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jfull = jax.tree.map(
        lambda small, big: jax.lax.dynamic_update_slice(big, small, (0,) * big.ndim),
        jcache, JM.init_cache(jc, 2, max_len))
    srv = Server(tc, tp, ServeConfig(max_len=max_len), device="cpu")
    tfull = srv._grow_cache(tcache, 2, S)
    for i in range(3):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jfull = JM.decode_step(jc, jp, jfull, jnp.asarray(nxt), jnp.int32(S + i))
        tl, tfull = TM.decode_step(tc, tp, tfull, torch.from_numpy(nxt), S + i)
        _close(tl, jl)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_chunk_and_decode_logits_match_jax(arch, backend):
    """Slot 0 prefills two chunks (the second ragged) into scattered pages,
    slot 1 one chunk; then one lockstep decode of both slots."""
    jc, tc, jp, tp = _setup(arch)
    tc = dataclasses.replace(tc, decode_backend=backend)
    maxp, num_pages = 3, 7
    table = np.array([[3, 5, 6], [2, 0, 0]], np.int32)
    p0, p1 = _tokens(3, 13, vocab=tc.vocab_size), _tokens(4, 6, vocab=tc.vocab_size)
    jcache = JM.init_paged_cache(jc, 2, num_pages, PAGE, maxp * PAGE)
    tcache = TM.init_paged_cache(tc, 2, num_pages, PAGE, maxp * PAGE, device="cpu")
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
    jl, _ = JM.decode_step_paged(jc, jp, jcache, jnp.asarray(nxt), jnp.asarray(seq),
                                 jnp.asarray(table), jnp.asarray([True, True]))
    tl, _ = TM.decode_step_paged(tc, tp, tcache, torch.from_numpy(nxt),
                                 torch.from_numpy(seq), torch.from_numpy(table),
                                 torch.tensor([True, True]))
    _close(tl, jl)


# --------------------------------------------------------------------------
# The engine against its own generate
# --------------------------------------------------------------------------

def _baseline(cfg, params, prompts, max_new):
    srv = Server(cfg, params, ServeConfig(max_len=64), device="cpu")
    return [srv.generate({"tokens": p[None]}, max_new)[0] for p in prompts]


def _run(cfg, params, ec, prompts, max_new, gap=1):
    eng = Engine(cfg, params, ec, device="cpu")
    ptrs = eng.kv.pool_ptrs()
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, rid=i, arrival_step=gap * i)
    reqs = eng.run()
    assert eng.kv.pool_ptrs() == ptrs  # the pool was written in place
    stats = eng.kv.audit()
    assert stats.slot_held == 0 and not eng.kv._pages
    assert stats.free + stats.index_pinned == stats.total
    return eng, reqs


def _assert_tokens(reqs, base):
    assert len(reqs) == len(base) and all(r.state == "finished" for r in reqs)
    for r, b in zip(reqs, base):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), b)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_single_chunk_prompts_match_own_generate(arch, backend):
    """Prompts that fit one prefill chunk: the dispatch sees the one-shot
    token group, so 3 requests through 2 slots equal generate exactly."""
    _, tc, _, tp = _setup(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tc.vocab_size, size=(n,)).astype(np.int32) for n in (8, 7, 6)]
    base = _baseline(tc, tp, prompts, 6)
    _, reqs = _run(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE,
                                        backend=backend), prompts, 6)
    _assert_tokens(reqs, base)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_unchunked_multi_page_prompts_match_own_generate(arch, backend):
    """``chunked_prefill=False``: each multi-page prompt is dispatched as
    the one-shot group ``Server.generate`` uses; a slot re-fill included."""
    _, tc, _, tp = _setup(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tc.vocab_size, size=(n,)).astype(np.int32)
               for n in (17, 20, 12)]
    base = _baseline(tc, tp, prompts, 6)
    eng, reqs = _run(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE,
                                          chunked_prefill=False, backend=backend),
                     prompts, 6)
    _assert_tokens(reqs, base)
    assert not eng.kv.sharing  # a recompute family shares only under chunking


def test_moe_stack_shares_pages_but_recomputes():
    """A MoE stack aliases prefix pages (memory dedup) while running every
    prefill chunk: shared and unshared runs are bit-identical, the partial
    tail page of a cached run is not aliased (no COW), and sharing switches
    itself off under one-shot prefill."""
    _, tc, _, tp = _setup("granite-moe-3b-a800m")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, tc.vocab_size, size=(24,)).astype(np.int32)
    prompts = [
        np.concatenate([shared, rng.integers(0, tc.vocab_size, size=(3,))]).astype(np.int32),
        np.concatenate([shared, rng.integers(0, tc.vocab_size, size=(5,))]).astype(np.int32),
        shared[:20].copy(),  # ends mid-page inside a cached run: clamps to 16
    ]

    def run(sharing):
        return _run(tc, tp, EngineConfig(max_seqs=1, max_len=40, page_size=PAGE,
                                         prefix_sharing=sharing), prompts, 6, gap=0)

    eng_s, reqs_s = run(True)
    eng_u, reqs_u = run(False)
    assert eng_s.kv.sharing and not eng_s.kv.skip_prefill
    for rs, ru in zip(reqs_s, reqs_u):
        assert rs.out_tokens == ru.out_tokens, rs.rid
    assert [r.stats.cached_prompt_tokens for r in reqs_s] == [0, 24, 16]
    assert eng_s.kv.cow_copies == 0
    assert eng_s.prefill_chunks == eng_u.prefill_chunks  # no compute skipped
    assert eng_s.kv.allocator.pages_allocated < eng_u.kv.allocator.pages_allocated
    eng_o = Engine(tc, tp, EngineConfig(max_seqs=1, max_len=40, page_size=PAGE,
                                        chunked_prefill=False), device="cpu")
    assert not eng_o.kv.sharing
