"""The port's vision frontend (Qwen2-VL: M-RoPE and the image prefix)
against the JAX package's, on the CPU, in fp32, at smoke size.

The JAX package's stub ``positions3`` puts ``arange(S)`` on all three
streams, where M-RoPE equals plain RoPE whatever the split; so every check
here runs on three *different* streams: Qwen2-VL's image grid (the image
rows at t = 0, h = i // width, w = i % width; the text after them counting
on all three streams from one past the grid's largest position), and a
deliberately wrong ``sections`` must change the result.  Tolerances:
``apply_mrope`` 1e-6, modules 1e-5, logits 1e-4 (the JAX suite's end to
end); greedy tokens under the margin rule of ``tests/test_torch_serve.py``.
"""
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
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as JM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import Server as JServer
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import model as TM
from repro_torch.serve import (
    Engine,
    EngineConfig,
    PagedCacheConfig,
    PagedKVCache,
    ServeConfig,
    Server,
    run_static_waves,
)

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen2-vl-72b"
MARGIN = 1e-3
B, S = 2, 20  # 8 image rows (the smoke config's n_frontend_tokens) + 12 text tokens


def grid_positions(batch: int, seq: int, n_image: int, width: int) -> np.ndarray:
    """Qwen2-VL's (3, batch, seq) position streams for an image of
    ``n_image`` patches in rows of ``width``, then text."""
    i = np.arange(n_image)
    img = np.stack([np.zeros(n_image), i // width, i % width])
    start = int(img.max()) + 1
    text = np.broadcast_to(start + np.arange(seq - n_image), (3, seq - n_image))
    p = np.concatenate([img, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(p[:, None], (3, batch, seq)))


@pytest.fixture(scope="module")
def setup():
    jc = JC.get_config(ARCH, smoke=True, dtype=jnp.float32)
    tc = TC.get_config(ARCH, smoke=True, dtype=torch.float32)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _inputs(cfg, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32),
        "vis_embeds": rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32),
        "positions3": grid_positions(batch, seq, cfg.n_frontend_tokens, 4),
    }


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


# --------------------------------------------------------------------------
# apply_mrope
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sections,d_head", [((2, 3, 3), 16), ((16, 24, 24), 128)],
                         ids=["smoke", "full"])
def test_apply_mrope_matches_jax(sections, d_head):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, d_head)).astype(np.float32)
    p3 = grid_positions(2, 40, 32, 8)
    assert len({tuple(s.ravel()) for s in p3}) == 3  # three different streams
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 1e6, sections)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6, sections)
    assert _err(got, want) <= 1e-6


@pytest.mark.parametrize("sections", [(3, 3, 2), (2, 2, 4), (8, 0, 0)])
def test_apply_mrope_wrong_sections_differ(sections):
    """A split other than the config's gives other angles on grid streams."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    p3 = torch.from_numpy(grid_positions(2, 40, 32, 8))
    right = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(p3.numpy()), 1e6, (2, 3, 3))
    wrong = tcommon.apply_mrope(torch.from_numpy(x), p3, 1e6, sections)
    assert _err(wrong, right) > 1e-2


def test_equal_streams_reduce_to_rope():
    """Why the tests use the grid: on the stub's equal streams M-RoPE is
    plain RoPE, for any split."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 12, 4, 16)).astype(np.float32))
    pos = TM.default_positions(2, 12)
    plain = tcommon.apply_rope(x, pos, 1e6)
    for sections in ((2, 3, 3), (8, 0, 0)):
        same = tcommon.apply_mrope(x, pos[None].expand(3, 2, 12), 1e6, sections)
        assert _err(same, plain) <= 1e-6


def test_frontend_stubs_match_jax(setup):
    jc, tc, _, _ = setup
    want = JM.frontend_extras(jc, {}, B, S)
    got = TM.frontend_extras(tc, {}, B, S, torch.device("cpu"))
    for k in ("vis_embeds", "positions3"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    kept = TM.frontend_extras(tc, {"vis_embeds": torch.ones(1)}, B, S, "cpu")
    assert kept["vis_embeds"].shape == (1,)  # an input already given stays


# --------------------------------------------------------------------------
# the attention module and the model
# --------------------------------------------------------------------------

def test_gqa_forward_with_mrope_matches_jax(setup):
    jc, tc, jp, tp = setup
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    p3 = grid_positions(B, S, 8, 4)
    jl = jax.tree.map(lambda a: a[0], jp["seg0"]["attn"])
    tl = {k: v[0] for k, v in tp["seg0"]["attn"].items()}
    for mode in ("train", "prefill"):
        want, jcache = jattn.gqa_forward(jl, jc, jnp.asarray(x), jnp.asarray(p3), mode=mode)
        got, tcache = tattn.gqa_forward(tl, tc, torch.from_numpy(x), torch.from_numpy(p3),
                                        mode=mode)
        assert _err(got, want) <= 1e-5
        if mode == "prefill":
            assert _err(tcache["k"], jcache["k"]) <= 1e-5  # rotated keys cached


def _jax_generate_path(jc, jp, batch, max_new):
    """The JAX package's static path by hand: prefill, then decode steps."""
    jsrv = JServer(jc, jp, JServeConfig(max_len=S + max_new + 4))
    logits, caches = jsrv._prefill(jp, _jax(batch))
    caches = jsrv._grow_cache(caches, batch["tokens"].shape[0], S)
    return jsrv, logits, caches


def test_prefill_and_decode_logits_match_jax(setup):
    jc, tc, jp, tp = setup
    batch = _inputs(tc)
    jsrv, jlog, jcaches = _jax_generate_path(jc, jp, batch, 3)
    srv = Server(tc, tp, ServeConfig(max_len=S + 7), device="cpu")
    tlog, tcaches = TM.prefill(tc, tp, _torch(batch))
    assert _err(tlog, jlog) <= 1e-4
    tcaches = srv._grow_cache(tcaches, B, S)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(3):  # decode: position S + i on all three streams
        jlog, jcaches = jsrv._decode(jp, jcaches, jnp.asarray(tok), jnp.int32(S + i))
        tlog, tcaches = TM.decode_step(tc, tp, tcaches, torch.from_numpy(tok), S + i)
        assert _err(tlog, jlog) <= 1e-4
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]


def test_image_and_streams_change_the_logits(setup):
    _, tc, _, tp = setup
    batch = _torch(_inputs(tc))
    base, _ = TM.prefill(tc, tp, batch)
    other = dict(batch, vis_embeds=batch["vis_embeds"] + 1.0)
    assert _err(TM.prefill(tc, tp, other)[0], base) > 1e-3
    flat = dict(batch, positions3=TM.default_positions(B, S)[None].expand(3, B, S))
    assert _err(TM.prefill(tc, tp, flat)[0], base) > 1e-3
    with pytest.raises(ValueError, match="longer than the prompt"):
        TM.prefill(tc, tp, dict(batch, tokens=batch["tokens"][:, :6],
                                positions3=batch["positions3"][..., :6]))


def test_server_generate_matches_jax_server(setup):
    """The batch's greedy tokens against the JAX package's Server, each
    divergence where the JAX baseline's top-2 margin (stepping its own
    decode path) is below 1e-3."""
    jc, tc, jp, tp = setup
    max_new = 6
    batch = _inputs(tc, seed=5)
    got = Server(tc, tp, ServeConfig(max_len=S + max_new + 4), device="cpu").generate(
        batch, max_new)
    jsrv, logits, caches = _jax_generate_path(jc, jp, batch, max_new)
    want = jsrv.generate(_jax(batch), max_new)
    assert got.shape == want.shape == (B, max_new)
    for b in range(B):
        if np.array_equal(got[b], want[b]):
            continue
        i = int(np.argmax(got[b] != want[b]))
        lg = logits
        for j in range(i):
            lg, caches = jsrv._decode(jp, caches, jnp.asarray(want[:, j:j + 1]),
                                      jnp.int32(S + j))
        top2 = np.sort(np.asarray(lg)[b, -1])[-2:]
        assert top2[1] - top2[0] < MARGIN, (b, i, top2)
    assert all(n == 0 for n in tk.launch_counts().values())  # no kernel on this path


def test_engine_and_paged_cache_refuse_vision(setup):
    _, tc, _, tp = setup
    reason = "has no cache adapter yet"
    with pytest.raises(NotImplementedError, match=reason):
        PagedKVCache(tc, PagedCacheConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match=reason):
        Engine(tc, tp, EngineConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match=reason):
        TM.init_paged_cache(tc, 2, 8, 8, 32, device="cpu")


def test_static_waves_serve_vision(setup):
    _, tc, _, tp = setup
    rng = np.random.default_rng(6)
    reqs = [{"rid": i, "prompt": rng.integers(0, tc.vocab_size, size=(S,)).astype(np.int32),
             "max_new_tokens": 4, "arrival_step": 0,
             "extras": {"vis_embeds": rng.standard_normal((1, 8, tc.d_model)).astype(
                 np.float32), "positions3": grid_positions(1, S, 8, 4)}}
            for i in range(3)]
    srv = Server(tc, tp, ServeConfig(max_len=S + 8), device="cpu")
    outs = run_static_waves(srv, reqs, 2)
    for r in reqs:  # a wave's rows equal each request alone
        alone = srv.generate({"tokens": r["prompt"][None], **r["extras"]}, 4)[0]
        np.testing.assert_array_equal(outs[r["rid"]], alone)


def test_cli_single_wave_and_static_engine_serve_vision():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
            "--device", "cpu", "--prompt-len", "12", "--max-new", "4"]
    r = subprocess.run(base + ["--batch", "2"], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "generated (2, 4) tokens" in r.stdout
    r = subprocess.run(base + ["--num-requests", "3", "--engine", "static"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[static-wave]  3 requests" in r.stdout
    r = subprocess.run(base + ["--num-requests", "3"], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and "rerun with --engine static" in r.stderr
