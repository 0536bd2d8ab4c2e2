"""The port's MLA (DeepSeek-V3 latent attention) against the JAX package's, on
the CPU, in fp32, at smoke widths.

The configuration is the ``deepseek-v3-671b`` smoke config with its MoE
stack replaced by a dense FFN, as the JAX suite's ``_mla_dense_cfg``
(tests/test_serve.py) isolates the latent-page adapter.  Both packages run
the JAX package's ``init_params`` weights, carried over with
``params_from_numpy``, on inputs from a numpy seed:

* ``mla_forward`` (prefill, decode), ``mla_paged_prefill_chunk`` and
  ``mla_paged_decode``, and the model's logits, within 1e-4 (the JAX
  suite's end-to-end tolerance), through both of the port's decode
  backends (``"cuda"`` takes the kernels' plain versions on the CPU);
* the MLA decode kernel's plain version against the JAX Pallas kernel in
  interpret mode and both packages' gather oracles within 1e-6 (the JAX
  suite's paged ``TOL``, tests/test_paged_kernels.py), ragged positions
  included;
* the port's engine against its own single-request ``Server.generate``,
  token for token, chunked and unchunked, and under prefix sharing with a
  copy-on-write, ending on a clean pool audit.  The JAX engine's tokens are
  not a target (ROADMAP.md queue 3 lists its MLA engine test as flaky).
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
from repro.kernels.paged_attention import mla_paged_attention_decode as jax_mla_decode
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch.kernels.paged_attention import mla_decode_plain, mla_paged_attention_decode
from repro_torch.models import adapters as A
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server

TOL = 1e-4
KERNEL_TOL = 1e-6
PAGE = 8
MAXP = 4
DENSE = dict(family="dense", n_experts=0, n_shared_experts=0, top_k=0, moe_d_ff=0,
             first_k_dense=0, mtp_depth=0, d_ff=96, block=PAGE)


def _cfgs():
    jc = dataclasses.replace(JC.get_config("deepseek-v3-671b", smoke=True,
                                           dtype=jnp.float32), **DENSE)
    tc = dataclasses.replace(TC.get_config("deepseek-v3-671b", smoke=True,
                                           dtype=torch.float32), **DENSE)
    return jc, tc


@pytest.fixture(scope="module")
def setup():
    jc, tc = _cfgs()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.fixture(autouse=True)
def _no_launches_on_the_cpu():
    tk.reset_launch_counts()
    yield
    assert all(n == 0 for n in tk.launch_counts().values()), "a kernel launched on the CPU"


def _close(a, b, tol=TOL):
    err = float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())
    assert err <= tol, err


def _tokens(seed, *shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# --------------------------------------------------------------------------
# Parameters, configuration, registry
# --------------------------------------------------------------------------

def test_params_from_numpy_carries_the_mla_leaves(setup):
    jc, tc, jp, tp = setup
    leaves = {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert set(jp["seg0"]["attn"]) == set(tp["seg0"]["attn"]) == leaves
    for name in leaves:
        got, want = tp["seg0"]["attn"][name], np.asarray(jp["seg0"]["attn"][name])
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    own = TM.init_params(tc, device="cpu")  # the port's own init: same keys and shapes
    assert _shapes(own) == _shapes(jax.tree.map(np.asarray, jp))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_dense_mla_cut_and_the_full_moe_model_are_served():
    """The dense cut shares and skips prefix compute; the full MLA + MoE
    model is served too (its MoE layers recompute every prefix chunk)."""
    _, tc = _cfgs()
    assert A.unsupported_reason(tc) is None
    assert A.all_adapters(tc) == [A.MLA_LATENT]
    assert A.prefix_shareable(tc) and A.prefix_compute_skippable(tc)
    full = TC.get_config("deepseek-v3-671b")
    assert A.unsupported_message(full) is None and A.all_adapters(full) == [A.MLA_LATENT]
    assert A.prefix_shareable(full) and not A.prefix_compute_skippable(full)
    cut = dataclasses.replace(full, n_layers=3, **{k: v for k, v in DENSE.items()
                                                   if k not in ("d_ff", "block")})
    assert A.unsupported_reason(cut) is None and cut.d_ff == 18432
    pools = tattn.mla_paged_cache_init(tc, 5, PAGE, device="cpu")
    assert {k: tuple(v.shape) for k, v in pools.items()} == {
        "ckv_pages": (5, PAGE, tc.kv_lora_rank), "krope_pages": (5, PAGE, tc.qk_rope_dim)}


# --------------------------------------------------------------------------
# The attention module against JAX
# --------------------------------------------------------------------------

def test_mla_forward_prefill_and_decode_match_jax(setup):
    """One layer's ``mla_forward``: prefill returns the latent cache; three
    decode steps against the grown static cache (in place in the port)."""
    jc, tc, jp, tp = setup
    jl, tl = _layer0(jp["seg0"]["attn"]), {k: v[0] for k, v in tp["seg0"]["attn"].items()}
    rng = np.random.default_rng(0)
    B, S, max_len = 2, 11, 16
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, jcache = jattn.mla_forward(jl, jc, jnp.asarray(x), jnp.asarray(pos), mode="prefill")
    tout, tcache = tattn.mla_forward(tl, tc, torch.from_numpy(x),
                                     torch.from_numpy(pos.copy()), mode="prefill")
    _close(tout, jout)
    for name in ("ckv", "krope", "pos"):
        _close(tcache[name], jcache[name], 1e-5)
    jfull = jattn.mla_cache_init(jc, B, max_len)
    jfull = jax.tree.map(lambda big, small: big.at[:, :S].set(small), jfull, jcache)
    tfull = tattn.mla_cache_init(tc, B, max_len, device="cpu")
    for name, t in tcache.items():
        tfull[name][:, :S] = t
    ptr = tfull["ckv"].data_ptr()
    for i in range(3):
        xi = rng.standard_normal((B, 1, tc.d_model)).astype(np.float32)
        p_i = np.full((B, 1), S + i, np.int32)
        jout, jfull = jattn.mla_forward(jl, jc, jnp.asarray(xi), jnp.asarray(p_i),
                                        mode="decode", cache=jfull, pos_offset=S + i)
        tout, tfull = tattn.mla_forward(tl, tc, torch.from_numpy(xi), torch.from_numpy(p_i),
                                        mode="decode", cache=tfull, pos_offset=S + i)
        _close(tout, jout)
    assert tfull["ckv"].data_ptr() == ptr
    _close(tfull["ckv"], jfull["ckv"], 1e-5)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_mla_paged_chunk_and_decode_match_jax(setup, backend):
    """One layer: slot 0 prefills two chunks (the second ragged) into
    scattered latent pages, slot 1 one chunk; then a lockstep decode with
    slot 1 inactive (its write lands on the null page)."""
    jc, tc, jp, tp = setup
    tc = dataclasses.replace(tc, decode_backend=backend)
    jl, tl = _layer0(jp["seg0"]["attn"]), {k: v[0] for k, v in tp["seg0"]["attn"].items()}
    rng = np.random.default_rng(1)
    num_pages = 7
    table = np.array([[3, 5, 6], [2, 0, 0]], np.int32)
    jcache = jattn.mla_paged_cache_init(jc, num_pages, PAGE)
    tcache = tattn.mla_paged_cache_init(tc, num_pages, PAGE, device="cpu")
    ptrs = [t.data_ptr() for t in tcache.values()]
    for slot, q_off, n in ((0, 0, 8), (0, 8, 5), (1, 0, 6)):
        x = rng.standard_normal((1, n, tc.d_model)).astype(np.float32)
        pos = (q_off + np.arange(n, dtype=np.int32))[None]
        phys = table[slot][pos[0] // PAGE].astype(np.int32)
        off = (pos[0] % PAGE).astype(np.int32)
        jout, jcache = jattn.mla_paged_prefill_chunk(
            jl, jc, jnp.asarray(x), jnp.asarray(pos), jcache, jnp.asarray(table[slot]),
            jnp.asarray(phys), jnp.asarray(off), q_off)
        tout, tcache = tattn.mla_paged_prefill_chunk(
            tl, tc, torch.from_numpy(x), torch.from_numpy(pos), tcache,
            torch.from_numpy(table[slot]), torch.from_numpy(phys), torch.from_numpy(off),
            q_off)
        _close(tout, jout)
    x = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
    seq = np.array([13, 6], np.int32)
    active = np.array([True, False])
    jout, jcache = jattn.mla_paged_decode(jl, jc, jnp.asarray(x), jnp.asarray(seq[:, None]),
                                          jcache, jnp.asarray(table), jnp.asarray(seq),
                                          jnp.asarray(active))
    tout, tcache = tattn.mla_paged_decode(tl, tc, torch.from_numpy(x),
                                          torch.from_numpy(seq[:, None].copy()), tcache,
                                          torch.from_numpy(table), torch.from_numpy(seq),
                                          torch.from_numpy(active))
    _close(tout[0], jout[0])  # slot 1 is inactive: its output is discarded
    for name in ("ckv_pages", "krope_pages"):
        _close(tcache[name][1:], np.asarray(jcache[name])[1:], 1e-5)  # page 0: garbage
    assert [t.data_ptr() for t in tcache.values()] == ptrs


def test_model_prefill_and_decode_logits_match_jax(setup):
    jc, tc, jp, tp = setup
    toks = _tokens(2, 2, 9)
    S, max_len = toks.shape[1], 16
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = TM.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    assert set(tcache["seg0"]["attn"]) == {"ckv", "krope", "pos"}
    jfull = jax.tree.map(
        lambda small, big: jax.lax.dynamic_update_slice(big, small, (0,) * big.ndim),
        jcache, JM.init_cache(jc, 2, max_len))
    tfull = TM.init_cache(tc, 2, max_len, device="cpu")
    for name, t in tcache["seg0"]["attn"].items():
        tfull["seg0"]["attn"][name][:, :, :S] = t
    for i in range(3):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jfull = JM.decode_step(jc, jp, jfull, jnp.asarray(nxt), jnp.int32(S + i))
        tl, tfull = TM.decode_step(tc, tp, tfull, torch.from_numpy(nxt), S + i)
        _close(tl, jl)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_model_paged_chunk_and_decode_logits_match_jax(setup, backend):
    jc, tc, jp, tp = setup
    tc = dataclasses.replace(tc, decode_backend=backend)
    maxp, num_pages = 3, 7
    table = np.array([[3, 5, 6], [2, 0, 0]], np.int32)
    p0, p1 = _tokens(3, 13), _tokens(4, 6)

    def chunk(slot, prompt, start, n):
        toks = prompt[None, start:start + n]
        pos = np.arange(start, start + n)
        phys = table[slot][pos // PAGE].astype(np.int32)
        return toks, slot, start, phys, (pos % PAGE).astype(np.int32), table[slot], n - 1

    steps = [chunk(0, p0, 0, 8), chunk(0, p0, 8, 5), chunk(1, p1, 0, 6)]
    jcache = JM.init_paged_cache(jc, 2, num_pages, PAGE, maxp * PAGE)
    tcache = TM.init_paged_cache(tc, 2, num_pages, PAGE, maxp * PAGE, device="cpu")
    for toks, slot, q_off, phys, off, row, last in steps:
        jl, jcache = JM.prefill_chunk(jc, jp, jcache, jnp.asarray(toks), slot, q_off,
                                      jnp.asarray(phys), jnp.asarray(off), jnp.asarray(row),
                                      last)
        tl, tcache = TM.prefill_chunk(tc, tp, tcache, torch.from_numpy(toks), slot, q_off,
                                      torch.from_numpy(phys), torch.from_numpy(off),
                                      torch.from_numpy(row), last)
        _close(tl, jl)
    nxt, seq = np.array([[7], [9]], np.int32), np.array([13, 6], np.int32)
    jl, _ = JM.decode_step_paged(jc, jp, jcache, jnp.asarray(nxt), jnp.asarray(seq),
                                 jnp.asarray(table), jnp.asarray([True, True]))
    tl, _ = TM.decode_step_paged(tc, tp, tcache, torch.from_numpy(nxt),
                                 torch.from_numpy(seq), torch.from_numpy(table),
                                 torch.tensor([True, True]))
    _close(tl, jl)


# --------------------------------------------------------------------------
# The MLA decode kernel's plain version against the Pallas kernel
# --------------------------------------------------------------------------

def _latent_layout(rng, B, used_pages, r, dr):
    """Per-slot table rows over ``used_pages`` distinct physical pages (page
    0 is the null page, never mapped; unused entries point at it) and random
    latent pools."""
    num_pages = B * MAXP + 1
    table = np.zeros((B, MAXP), np.int32)
    phys = rng.permutation(np.arange(1, num_pages))
    for b in range(B):
        table[b, :used_pages] = phys[b * used_pages:(b + 1) * used_pages]
    ckv = rng.standard_normal((num_pages, PAGE, r)).astype(np.float32)
    kr = rng.standard_normal((num_pages, PAGE, dr)).astype(np.float32)
    return table, ckv, kr


def _edge_positions(used_pages):
    last = (used_pages - 1) * PAGE
    return sorted({0, last, last + PAGE // 2, used_pages * PAGE - 1})


def _mla_all(q_lat, q_rope, ckv, kr, table, seq_pos, scale):
    """(port kernel wrapper, JAX kernel, JAX oracle, port oracle) as numpy."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q_lat, q_rope, ckv, kr, table,
                                                             seq_pos)]
    j = [jnp.asarray(a) for a in (q_lat, q_rope, ckv, kr, table, seq_pos)]
    return (mla_paged_attention_decode(*t, scale=scale).numpy(),
            np.asarray(jax_mla_decode(*j, scale=scale, interpret=True)),
            np.asarray(jattn.mla_paged_gather_attend(*j, scale=scale)),
            tattn.mla_paged_gather_attend(*t, scale=scale).numpy())


@pytest.mark.parametrize("used_pages", [1, 2, 4])
def test_mla_plain_kernel_matches_pallas(used_pages):
    rng = np.random.default_rng(used_pages)
    B, H, r, dr = 2, 4, 16, 8
    scale = (24 + dr) ** -0.5  # absorbed qk_nope + rope dims, as in MLA
    table, ckv, kr = _latent_layout(rng, B, used_pages, r, dr)
    q_lat = rng.standard_normal((B, 1, H, r)).astype(np.float32)
    q_rope = rng.standard_normal((B, 1, H, dr)).astype(np.float32)
    for pos in _edge_positions(used_pages):
        seq_pos = np.full((B,), pos, np.int32)
        port, jax_out, jax_ref, port_ref = _mla_all(q_lat, q_rope, ckv, kr, table, seq_pos,
                                                    scale)
        assert port.shape == jax_out.shape and port.dtype == jax_out.dtype
        for other in (jax_out, jax_ref, port_ref):
            err = float(np.abs(port - other).max())
            assert err <= KERNEL_TOL, (used_pages, pos, err)


def test_mla_plain_kernel_ragged_positions():
    """Slots at different fill levels in one call, at the smoke config's
    widths (r = 24, dr = 8, 2 heads): each row masks by its own seq_pos and
    null pages in unused table entries stay masked."""
    rng = np.random.default_rng(3)
    B, H, r, dr = 3, 2, 24, 8
    table, ckv, kr = _latent_layout(rng, B, MAXP, r, dr)
    table[0, 1:] = 0
    q_lat = rng.standard_normal((B, 1, H, r)).astype(np.float32)
    q_rope = rng.standard_normal((B, 1, H, dr)).astype(np.float32)
    seq_pos = np.array([0, PAGE - 1, MAXP * PAGE - 1], np.int32)
    port, jax_out, jax_ref, port_ref = _mla_all(q_lat, q_rope, ckv, kr, table, seq_pos,
                                                24 ** -0.5)
    for other in (jax_out, jax_ref, port_ref):
        assert float(np.abs(port - other).max()) <= KERNEL_TOL


def test_mla_plain_kernel_bf16_pools_round_once():
    """bf16: the plain version computes in fp32 (probabilities included) and
    rounds once, so it is within one bf16 rounding of the fp32 computation
    on the same bf16-valued inputs."""
    rng = np.random.default_rng(5)
    B, H, r, dr = 2, 4, 16, 8
    table, ckv, kr = _latent_layout(rng, B, 3, r, dr)
    q_lat = rng.standard_normal((B, 1, H, r)).astype(np.float32)
    q_rope = rng.standard_normal((B, 1, H, dr)).astype(np.float32)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q_lat, q_rope, ckv, kr)]
    t, s = torch.from_numpy(table), torch.tensor([5, 3 * PAGE - 2], dtype=torch.int32)
    out = mla_paged_attention_decode(*bf, t, s, scale=0.2)
    assert out.dtype == torch.bfloat16
    want = mla_decode_plain(*(a.float() for a in bf), t, s, scale=0.2)
    assert torch.all((out.float() - want).abs() <= 2.0 ** -8 * want.abs() + 1e-6)


def test_mla_plain_kernel_rejects_bad_operands():
    q, qr = torch.zeros(2, 1, 4, 16), torch.zeros(2, 1, 4, 8)
    ckv, kr = torch.zeros(5, PAGE, 16), torch.zeros(5, PAGE, 8)
    table, seq = torch.zeros(2, MAXP, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        mla_paged_attention_decode(q, qr, ckv, kr, table.long(), seq, scale=1.0)
    with pytest.raises(TypeError, match="share"):
        mla_paged_attention_decode(q, qr, ckv.double(), kr, table, seq, scale=1.0)
    with pytest.raises(ValueError, match="pools must be"):
        mla_paged_attention_decode(q, qr, torch.zeros(5, PAGE, 12), kr, table, seq, scale=1.0)
    with pytest.raises(ValueError, match="q_lat must be"):
        mla_paged_attention_decode(q, torch.zeros(2, 1, 3, 8), ckv, kr, table, seq, scale=1.0)


# --------------------------------------------------------------------------
# The engine over latent pages
# --------------------------------------------------------------------------

def _baseline(cfg, params, prompts, max_new):
    srv = Server(cfg, params, ServeConfig(max_len=64), device="cpu")
    return [srv.generate({"tokens": p[None]}, max_new)[0] for p in prompts]


def _run(cfg, params, ec, prompts, max_new, gap=2):
    eng = Engine(cfg, params, ec, device="cpu")
    ptrs = eng.kv.pool_ptrs()
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, rid=i, arrival_step=gap * i)
    reqs = eng.run()
    assert eng.kv.pool_ptrs() == ptrs  # the latent pool was written in place
    stats = eng.kv.audit()
    assert stats.slot_held == 0 and not eng.kv._pages
    assert stats.free + stats.index_pinned == stats.total
    return eng, reqs


def _assert_tokens(reqs, base):
    assert len(reqs) == len(base) and all(r.state == "finished" for r in reqs)
    for r, b in zip(reqs, base):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), b)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("chunked", [True, False])
def test_mla_engine_matches_own_generate(setup, chunked, backend):
    """3 requests through 2 slots (a slot re-fill), multi-chunk prompts:
    tokens equal the port's single-request generate exactly."""
    _, tc, _, tp = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, size=(n,)).astype(np.int32)
               for n in (12, 9, 14)]
    base = _baseline(tc, tp, prompts, 8)
    eng, reqs = _run(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE,
                                          chunked_prefill=chunked, backend=backend),
                     prompts, 8)
    _assert_tokens(reqs, base)
    pool = eng.kv.data["seg0"]["attn"]
    assert set(pool) == {"ckv_pages", "krope_pages"}
    assert pool["ckv_pages"].shape[-1] == tc.kv_lora_rank


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_mla_shared_prefix_copy_on_write(setup, backend):
    """The second prompt is the first 20 tokens of the first: it aliases the
    cached latent pages, including the partial tail page, and its first
    decode write copies that page in both latent pools (COW)."""
    _, tc, _, tp = setup
    rng = np.random.default_rng(21)
    shared = rng.integers(0, tc.vocab_size, size=(24,)).astype(np.int32)
    pa = np.concatenate([shared, rng.integers(0, tc.vocab_size, size=(3,))]).astype(np.int32)
    pc = shared[:20].copy()
    base = _baseline(tc, tp, [pa, pc], 8)
    eng, reqs = _run(tc, tp, EngineConfig(max_seqs=2, max_len=48, page_size=PAGE,
                                          backend=backend), [pa, pc], 8, gap=4)
    _assert_tokens(reqs, base)
    assert eng.kv.cow_copies >= 1
    assert [r.stats.cached_prompt_tokens for r in reqs] == [0, 20]
