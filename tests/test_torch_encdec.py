"""The port's encoder-decoder family (whisper) against the JAX package's, on
the CPU, in fp32, at the ``whisper-tiny`` smoke size (2 + 2 layers, 32
audio frames, d_model 64).

Both packages run the JAX package's ``init_params`` weights, carried over
with ``params_from_numpy``, on tokens and random audio embeddings from a
numpy seed:

* ``cross_attention``, ``_encoder_forward`` and ``encdec_cross_kv`` within
  1e-5;
* prefill and decode logits within 1e-4, and the engine's chunk and
  paged-decode steps over installed cross rows;
* the port's engine against its own ``Server.generate``, token for token,
  with each request's own audio, chunked and unchunked;
* a request preempted mid-prefill re-runs its encoder on re-admission and
  keeps its tokens;
* two requests with equal tokens and different audio share no page;
* the decode runs ``paged_attention_decode`` (its plain version on the
  CPU) once per layer per decode step, and no page copy.
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
from repro.models import adapters as JA
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch.core import backend as tbackend
from repro_torch.models import adapters as A
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server

ARCH = "whisper-tiny"
TOL = 1e-4  # logits (ROADMAP.md)
MODULE_TOL = 1e-5
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
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    err = float(np.abs(a - np.asarray(b)).max())
    assert err <= tol, err


def _audio(rng, cfg, n=1):
    return rng.standard_normal((n, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _prompts(rng, cfg, lens):
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32) for n in lens]


# --------------------------------------------------------------------------
# Modules against JAX
# --------------------------------------------------------------------------

def test_cross_attention_matches_jax(setup):
    jc, tc, jp, tp = setup
    rng = np.random.default_rng(0)
    jl = jax.tree.map(lambda a: a[1], jp["cross"]["attn"])
    tl = {k: v[1] for k, v in tp["cross"]["attn"].items()}
    x = rng.standard_normal((2, 5, tc.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((2, tc.encoder_seq, tc.n_kv_heads, tc.d_head))
            .astype(np.float32) for _ in range(2))
    want = jattn.cross_attention(jl, jc, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v))
    got = tattn.cross_attention(tl, tc, *map(torch.from_numpy, (x, k, v)))
    _close(got, want, MODULE_TOL)


def test_encoder_and_cross_kv_match_jax(setup):
    jc, tc, jp, tp = setup
    audio = _audio(np.random.default_rng(1), tc, 2)
    _close(TM._encoder_forward(tc, tp, torch.from_numpy(audio)),
           JM._encoder_forward(jc, jp, jnp.asarray(audio)), MODULE_TOL)
    jkv = JM.encdec_cross_kv(jc, jp, jnp.asarray(audio))
    tkv = TM.encdec_cross_kv(tc, tp, torch.from_numpy(audio))
    assert tkv["k"].shape == (tc.n_layers, 2, tc.encoder_seq, tc.n_kv_heads, tc.d_head)
    for name in ("k", "v"):
        _close(tkv[name], jkv[name], MODULE_TOL)


def test_prefill_and_decode_logits_match_jax(setup):
    jc, tc, jp, tp = setup
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tc.vocab_size, size=(2, 11)).astype(np.int32)
    audio = _audio(rng, tc, 2)
    S, max_len = toks.shape[1], 24
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks),
                                     "audio_embeds": jnp.asarray(audio)})
    tl, tcache = TM.prefill(tc, tp, {"tokens": torch.from_numpy(toks),
                                     "audio_embeds": torch.from_numpy(audio)})
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
def test_chunk_and_paged_decode_logits_match_jax(setup, backend):
    """Each slot's cross rows installed from its own audio; slot 0 prefills
    13 tokens in two chunks, slot 1 six; then one lockstep decode."""
    jc, tc, jp, tp = setup
    tc = dataclasses.replace(tc, decode_backend=backend)
    maxp, num_pages = 3, 7
    table = np.array([[3, 5, 6], [2, 0, 0]], np.int32)
    rng = np.random.default_rng(4)
    p0, p1 = _prompts(rng, tc, (13, 6))
    jcache = JM.init_paged_cache(jc, 2, num_pages, PAGE, maxp * PAGE)
    tcache = TM.init_paged_cache(tc, 2, num_pages, PAGE, maxp * PAGE, device="cpu")
    assert set(tcache["seg0"]) == {"attn", "cross"} == set(jcache["seg0"])
    for slot in (0, 1):
        audio = _audio(rng, tc)
        src = A.CROSS_ENC.admission_src(tc, tp, {"audio_embeds": torch.from_numpy(audio)})
        A.CROSS_ENC.install(tc, tcache["seg0"]["cross"], src["seg0"]["cross"], slot, None,
                            None)
        jkv = JM.encdec_cross_kv(jc, jp, jnp.asarray(audio))
        jcache["seg0"]["cross"] = JA.write_slot_rows(jcache["seg0"]["cross"], jkv, slot,
                                                     axis=1)
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

def _baseline(tc, tp, prompts, audios, max_new):
    srv = Server(tc, tp, ServeConfig(max_len=60), device="cpu")
    return [srv.generate({"tokens": p[None], "audio_embeds": a}, max_new)[0]
            for p, a in zip(prompts, audios)]


def test_encdec_is_served_unshared(setup):
    _, tc, _, _ = setup
    assert A.unsupported_reason(tc) is None
    assert A.all_adapters(tc) == [A.PAGED_GQA, A.CROSS_ENC]
    assert A.admission_adapters(tc) == [A.CROSS_ENC]
    assert (A.prefix_shareable(tc), A.prefix_compute_skippable(tc)) == (False, False)
    assert A.prefill_chunk_multiple(tc) == 1


@pytest.mark.parametrize("chunked", [True, False])
def test_engine_matches_own_generate_with_per_request_audio(setup, chunked):
    """3 requests through 2 slots (a slot re-fill), each with its own audio:
    tokens equal generate's with the same audio; Engine.generate splits a
    batch's audio per request."""
    _, tc, _, tp = setup
    rng = np.random.default_rng(2)
    prompts = _prompts(rng, tc, (12, 9, 14))
    audios = [_audio(rng, tc) for _ in prompts]
    base = _baseline(tc, tp, prompts, audios, 8)
    eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE,
                                      chunked_prefill=chunked, debug_audit=True), device="cpu")
    for i, (p, a) in enumerate(zip(prompts, audios)):
        eng.submit(p, 8, rid=i, arrival_step=i, extras={"audio_embeds": a})
    reqs = eng.run()
    assert len(reqs) == 3 and all(r.state == "finished" for r in reqs)
    for r, b in zip(reqs, base):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), b)
    assert not eng.kv.audit().slot_held
    same = prompts[0][:9]
    batch = {"tokens": np.stack([same, prompts[1]]),
             "audio_embeds": np.concatenate([audios[2], audios[1]])}
    eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE,
                                      chunked_prefill=chunked), device="cpu")
    srv = Server(tc, tp, ServeConfig(max_len=60), device="cpu")
    np.testing.assert_array_equal(eng.generate(batch, 6), srv.generate(batch, 6))


def test_mid_prefill_preemption_reruns_the_encoder(setup, monkeypatch):
    """A request preempted mid-chunked-prefill re-runs its encoder on
    re-admission (the cross rows belong to the slot, not the request) and
    still matches its generate bit for bit."""
    _, tc, _, tp = setup
    rng = np.random.default_rng(9)
    short, long = _prompts(rng, tc, (8, 16))
    audios = [_audio(rng, tc) for _ in range(2)]
    base = _baseline(tc, tp, [short, long], audios, 8)
    encoded = []
    real = TM.encdec_cross_kv
    monkeypatch.setattr(TM, "encdec_cross_kv",
                        lambda cfg, params, audio: encoded.append(audio) or real(cfg, params, audio))
    eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=24, page_size=4, num_pages=9,
                                      prefill_tokens_per_step=4), device="cpu")
    a = eng.submit(short, 8, rid=0, extras={"audio_embeds": audios[0]})
    b = eng.submit(long, 8, rid=1, extras={"audio_embeds": audios[1]})
    preempted_mid_prefill = False
    for _ in range(200):
        if not eng.sched.has_work():
            break
        mid = b.prefilling and 0 < b.prefill_pos
        eng.step()
        if mid and b.state == "waiting":
            preempted_mid_prefill = True
    eng._flush_pending()
    assert preempted_mid_prefill, "no preemption landed mid-prefill"
    assert b.stats.n_preemptions >= 1
    # one encoder pass per admission: each request once, b again per preemption
    assert len(encoded) == 2 + a.stats.n_preemptions + b.stats.n_preemptions
    np.testing.assert_array_equal(np.asarray(a.out_tokens), base[0])
    np.testing.assert_array_equal(np.asarray(b.out_tokens), base[1])


def test_equal_tokens_with_different_audio_share_no_page(setup):
    """Two page-aligned prompts with equal tokens but different audio: the
    side inputs keep sharing off even when it is asked for, so no page is
    aliased and each request decodes against its own encoder."""
    _, tc, _, tp = setup
    rng = np.random.default_rng(5)
    (prompt,) = _prompts(rng, tc, (16,))
    audios = [_audio(rng, tc) for _ in range(2)]
    base = _baseline(tc, tp, [prompt, prompt], audios, 6)
    eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE,
                                      prefix_sharing=True), device="cpu")
    assert not eng.kv.sharing and eng.kv.index is None
    reqs = [eng.submit(prompt, 6, rid=i, arrival_step=i, extras={"audio_embeds": a})
            for i, a in enumerate(audios)]
    while not all(r.state == "running" and not r.prefilling for r in reqs):
        eng.step()
    pages = [set(eng.kv._pages[slot]) for slot, _ in eng.sched.running]
    assert len(pages) == 2 and not pages[0] & pages[1]
    eng.run()
    assert eng.kv.pages_aliased == 0 and eng.kv.cow_copies == 0
    assert [r.stats.cached_prompt_tokens for r in reqs] == [0, 0]
    for r, b in zip(reqs, base):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), b)


def test_decode_reads_paged_attention_once_per_layer_and_step(setup, monkeypatch):
    """The ``"cuda"`` backend's decode goes through paged_attention_decode
    (its plain version for CPU tensors) once per decoder layer and decode
    step, and copies no page."""
    _, tc, _, tp = setup
    calls = {"paged_attention_decode": 0, "paged_copy_page": 0}
    cls = tbackend.CudaBackend
    for name in calls:
        real = getattr(cls, name)

        def counted(self, *args, _real=real, _name=name):
            calls[_name] += 1
            return _real(self, *args)

        monkeypatch.setattr(cls, name, counted)
    rng = np.random.default_rng(6)
    prompts = _prompts(rng, tc, (10, 7, 12))
    eng = Engine(tc, tp, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, 5, rid=i, arrival_step=i, extras={"audio_embeds": _audio(rng, tc)})
    eng.run()
    assert eng.decode_steps > 0
    # + 1: the decode runner's warm-up step at construction (every slot
    # inactive), which the card's capture follows
    assert calls == {"paged_attention_decode": tc.n_layers * (eng.decode_steps + 1),
                     "paged_copy_page": 0}
