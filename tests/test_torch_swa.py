"""The port's sliding-window attention and its ring cache against the JAX
package's, on the CPU, in fp32, at the ``h2o-danube-3-4b`` smoke size
(window 8, GQA 8 heads over 2).

Both packages run the JAX package's ``init_params`` weights, carried over
with ``params_from_numpy``, on inputs from a numpy seed:

* ``gqa_forward`` prefill (the ring packing: the trailing ``window``
  tokens in ring order) and decode against a grown ring, with prompts
  shorter and longer than the window, within 1e-4;
* ``gqa_ring_prefill_chunk`` over several chunks that wrap the ring and
  ``gqa_ring_decode`` with an inactive slot, whose ring row must stay bit
  for bit as it was;
* ``RingAttnAdapter``: ``install`` places a prefill ring and blanks the
  rest of the row, the first chunk of a re-used slot resets its labels;
* the model's prefill, decode, chunk and paged-decode logits within 1e-4;
* the port's engine against its own ``Server.generate``, token for token,
  chunked and unchunked, with prompts longer than the window.
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
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch.models import adapters as A
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server

ARCH = "h2o-danube-3-4b"
TOL = 1e-4
PAGE = 8


def _cfgs(**over):
    over = {"block": PAGE, **over}
    jc = dataclasses.replace(JC.get_config(ARCH, smoke=True, dtype=jnp.float32), **over)
    tc = dataclasses.replace(TC.get_config(ARCH, smoke=True, dtype=torch.float32), **over)
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


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["seg0"]["attn"]),
            {k: v[0] for k, v in tp["seg0"]["attn"].items()})


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# The attention module against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [5, 8, 13])
def test_gqa_forward_ring_prefill_and_decode_match_jax(setup, S):
    """Prefill keeps the trailing min(window, S) tokens (in ring order once
    the ring is full); decode steps write slot pos % slots of the grown ring
    and attend within the window."""
    jc, tc, jp, tp = setup
    jl, tl = _layer0(jp, tp)
    rng = np.random.default_rng(S)
    B, max_len = 2, 24
    x = _x(rng, B, S, tc.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jout, jcache = jattn.gqa_forward(jl, jc, jnp.asarray(x), jnp.asarray(pos), mode="prefill")
    tout, tcache = tattn.gqa_forward(tl, tc, torch.from_numpy(x), torch.from_numpy(pos),
                                     mode="prefill")
    _close(tout, jout)
    assert tcache["k"].shape[1] == min(tc.window, S)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], 1e-5)
    jfull = jax.tree.map(
        lambda small, big: jax.lax.dynamic_update_slice(big, small, (0,) * big.ndim),
        jcache, jattn.gqa_cache_init(jc, B, max_len, window_only=True))
    tfull = tattn.gqa_cache_init(tc, B, max_len, device="cpu", window_only=True)
    assert tfull["k"].shape[1] == tc.window
    for name, t in tcache.items():
        tfull[name][:, :t.shape[1]] = t
    for i in range(6):  # past the window: the ring overwrites its oldest slots
        xi = _x(rng, B, 1, tc.d_model)
        p_i = np.full((B, 1), S + i, np.int32)
        jout, jfull = jattn.gqa_forward(jl, jc, jnp.asarray(xi), jnp.asarray(p_i),
                                        mode="decode", cache=jfull, pos_offset=S + i)
        tout, tfull = tattn.gqa_forward(tl, tc, torch.from_numpy(xi), torch.from_numpy(p_i),
                                        mode="decode", cache=tfull, pos_offset=S + i)
        _close(tout, jout)
    np.testing.assert_array_equal(tfull["pos"].numpy(), np.asarray(jfull["pos"]))


def test_ring_prefill_chunk_and_decode_match_jax(setup):
    """One slot's ring built by three chunks (5, 7, 6 tokens: the ring of 8
    wraps twice), then a lockstep decode of 3 slots in which slot 1 is
    inactive: its ring row stays bit for bit as it was."""
    jc, tc, jp, tp = setup
    jl, tl = _layer0(jp, tp)
    rng = np.random.default_rng(7)
    B = 3
    jring = jattn.gqa_cache_init(jc, B, 32, window_only=True)
    tring = tattn.gqa_cache_init(tc, B, 32, device="cpu", window_only=True)
    # give the other slots some content, as earlier requests would
    for name in ("k", "v"):
        junk = _x(rng, *tring[name].shape)
        tring[name].copy_(torch.from_numpy(junk))
        jring[name] = jnp.asarray(junk)
    other = np.tile(np.arange(8, 16, dtype=np.int32), (B, 1))
    tring["pos"].copy_(torch.from_numpy(other))
    jring["pos"] = jnp.asarray(other)
    tring["pos"][0] = -1
    jring["pos"] = jring["pos"].at[0].set(-1)
    q_off = 0
    for n in (5, 7, 6):
        x = _x(rng, 1, n, tc.d_model)
        pos = (q_off + np.arange(n, dtype=np.int32))[None]
        jrow = {k: v[0:1] for k, v in jring.items()}
        trow = A.read_slot_rows(tring, 0)
        jout, jrow = jattn.gqa_ring_prefill_chunk(jl, jc, jnp.asarray(x), jnp.asarray(pos),
                                                  jrow, q_off, window=jc.window)
        jring = {k: jring[k].at[0:1].set(jrow[k]) for k in jring}
        tout, _ = tattn.gqa_ring_prefill_chunk(tl, tc, torch.from_numpy(x),
                                               torch.from_numpy(pos), trow, q_off,
                                               window=tc.window)
        _close(tout, jout)
        q_off += n
    np.testing.assert_array_equal(tring["pos"].numpy(), np.asarray(jring["pos"]))
    _close(tring["k"], jring["k"], 1e-5)
    x = _x(rng, B, 1, tc.d_model)
    seq = np.array([q_off, 3, 16], np.int32)
    active = np.array([True, False, True])
    before = {k: v[1].clone() for k, v in tring.items()}
    jout, jring = jattn.gqa_ring_decode(jl, jc, jnp.asarray(x), jnp.asarray(seq[:, None]),
                                        jring, jnp.asarray(seq), window=jc.window,
                                        active=jnp.asarray(active))
    tout, tring = tattn.gqa_ring_decode(tl, tc, torch.from_numpy(x),
                                        torch.from_numpy(seq[:, None].copy()), tring,
                                        torch.from_numpy(seq), window=tc.window,
                                        active=torch.from_numpy(active))
    _close(tout[active.nonzero()[0]], np.asarray(jout)[active])  # slot 1's output is discarded
    for name in ("k", "v", "pos"):
        assert torch.equal(tring[name][1], before[name]), name
        _close(tring[name], jring[name], 1e-5)


def test_ring_adapter_install_and_first_chunk_reset(setup):
    """``install`` puts a short prefill ring at the row's head and blanks the
    rest; a re-used slot's first chunk resets the labels its previous
    occupant left, so it computes what a fresh pool computes."""
    jc, tc, jp, tp = setup
    jl, tl = _layer0(jp, tp)
    ad = A.RING_SWA
    geom = A.CacheGeometry(max_seqs=2, num_pages=9, page_size=PAGE, max_len=32)
    pool = TM._stacked(ad.init_pool(tc, geom, device="cpu"), 2)  # (L, max_seqs, slots, ...)
    pool["pos"].fill_(5)
    pool["k"].fill_(3.0)
    src = {"k": torch.ones(2, 1, 5, tc.n_kv_heads, tc.d_head),
           "v": torch.ones(2, 1, 5, tc.n_kv_heads, tc.d_head),
           "pos": torch.arange(5, dtype=torch.int32)[None, None].expand(2, 1, 5).contiguous()}
    ad.install(tc, pool, src, 1, None, None)
    assert pool["pos"][:, 1].tolist() == [[0, 1, 2, 3, 4, -1, -1, -1]] * 2
    assert pool["k"][:, 1, 5:].eq(0).all() and pool["k"][:, 1, :5].eq(1).all()
    assert pool["pos"][:, 0].eq(5).all() and pool["k"][:, 0].eq(3).all()  # slot 0 untouched

    rng = np.random.default_rng(9)
    x = torch.from_numpy(_x(rng, 1, 6, tc.d_model))
    positions = torch.arange(6, dtype=torch.int32)[None]
    ctx = {"slot": 1, "first": True}
    layer = {k: v[0] for k, v in pool.items()}  # (max_seqs, slots, ...) of layer 0
    used, _ = ad.chunk(tl, tc, x, positions, layer, ctx, 0)
    fresh = tattn.gqa_cache_init(tc, 2, 32, device="cpu", window_only=True)
    want, _ = ad.chunk(tl, tc, x, positions, fresh, ctx, 0)
    assert torch.equal(used, want)
    assert torch.equal(layer["pos"][1], fresh["pos"][1])


# --------------------------------------------------------------------------
# Model logits against JAX
# --------------------------------------------------------------------------

def test_prefill_and_decode_logits_match_jax(setup):
    jc, tc, jp, tp = setup
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, size=(2, 13)).astype(np.int32)
    S, max_len = toks.shape[1], 24
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = TM.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jfull = jax.tree.map(
        lambda small, big: jax.lax.dynamic_update_slice(big, small, (0,) * big.ndim),
        jcache, JM.init_cache(jc, 2, max_len))
    tfull = Server(tc, tp, ServeConfig(max_len=max_len), device="cpu")._grow_cache(tcache, 2, S)
    for i in range(4):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jfull = JM.decode_step(jc, jp, jfull, jnp.asarray(nxt), jnp.int32(S + i))
        tl, tfull = TM.decode_step(tc, tp, tfull, torch.from_numpy(nxt), S + i)
        _close(tl, jl)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_ring_chunk_and_decode_logits_match_jax(setup, backend):
    """Slot 0 prefills 13 tokens in two chunks (the ring wraps), slot 1 six;
    then one lockstep decode of both slots (the ring runs no kernel through
    either backend)."""
    jc, tc, jp, tp = setup
    tc = dataclasses.replace(tc, decode_backend=backend)
    maxp, num_pages = 3, 7
    table = np.array([[3, 5, 6], [2, 0, 0]], np.int32)
    rng = np.random.default_rng(4)
    p0, p1 = (rng.integers(0, tc.vocab_size, size=(n,)).astype(np.int32) for n in (13, 6))
    jcache = JM.init_paged_cache(jc, 2, num_pages, PAGE, maxp * PAGE)
    tcache = TM.init_paged_cache(tc, 2, num_pages, PAGE, maxp * PAGE, device="cpu")
    assert set(tcache["seg0"]["attn"]) == {"k", "v", "pos"}
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
# The registry and the engine against its own generate
# --------------------------------------------------------------------------

def test_swa_is_served_by_the_ring_unshared():
    _, tc = _cfgs()
    assert A.unsupported_reason(tc) is None
    assert A.all_adapters(tc) == [A.RING_SWA] and not A.RING_SWA.paged
    assert not A.prefix_shareable(tc) and not A.prefix_compute_skippable(tc)
    assert A.RING_SWA.family in A.supported_families()


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("chunked", [True, False])
def test_engine_matches_own_generate(setup, chunked, backend):
    """3 requests through 2 slots (a slot re-fill), prompts longer than the
    window of 8, multi-chunk when chunked: tokens equal generate exactly."""
    _, tc, _, tp = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, size=(n,)).astype(np.int32)
               for n in (12, 9, 14)]
    srv = Server(tc, tp, ServeConfig(max_len=64), device="cpu")
    base = [srv.generate({"tokens": p[None]}, 8)[0] for p in prompts]
    eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE,
                                      chunked_prefill=chunked, backend=backend),
                 device="cpu")
    assert not eng.kv.sharing
    ptrs = eng.kv.pool_ptrs()
    for i, p in enumerate(prompts):
        eng.submit(p, 8, rid=i, arrival_step=2 * i)
    reqs = eng.run()
    assert eng.kv.pool_ptrs() == ptrs  # the rings were written in place
    stats = eng.kv.audit()
    assert stats.slot_held == 0 and stats.free == stats.total
    assert len(reqs) == 3 and all(r.state == "finished" for r in reqs)
    for r, b in zip(reqs, base):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), b)
