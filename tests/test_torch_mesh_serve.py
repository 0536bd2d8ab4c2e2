"""Tensor-parallel serving of the port: ``gloo`` ranks on the CPU against the
port's single-device engine and the JAX package's.

The twins of ``tests/test_mesh_serve.py`` (dense chunked prefill on both
backends, ``Server`` static waves, the MoE stack, MLA latent pages,
preemption and recompute, shared-prefix copy-on-write, the non-dividing
rejection) run at TP 4 with that file's head lifts, and the same four ranks
serve as a ``2 x 2`` mesh once.  Deviations: the MLA
twin serves DeepSeek-V3's stock 2 heads, which a 4-way axis does not split
into whole heads -- where the JAX rules shard the attention's columns and
GSPMD serves the rest, each rank of the port runs the whole attention and
skips its sum while the other products stay sharded; TP 3 takes the JAX
rules' fallback for a vocab that does not split; then one case per family
the engine serves runs at TP 2, its weights carried as numpy arrays to both
packages.  Every rank's
tokens must equal the single-device port engine's (a divergence is excused
only where the baseline's top-2 logit margin is below ``MARGIN``, and the
excused ones are counted), be the same on every rank, and each rank hold
``1/M`` of a head-sharded pool and all of a replicated one; the family
cases' first decode logits must lie within ``LOGIT_TOL`` of the JAX
single-device engine's.

One module-scoped fixture starts the ranks once (``tests/torch_mesh_ranks.py``,
one process a rank, a ``FileStore`` in the test's temporary directory, every
group with a timeout) and computes the baselines while they run.  The paged
kernels' per-rank cases (local heads against the head slice of the full
call) need no process group.
"""
import dataclasses
import inspect
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as C
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.axes import abstract_mesh
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import model as M
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server

REPO = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).resolve().parent / "torch_mesh_ranks.py"
RANKS_TIMEOUT_S = 240  # the ranks' own collectives time out after 60 s
MARGIN = 1e-3
LOGIT_TOL = 1e-4


def _prompts(vocab, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in sizes]


def _ec(**kw):
    return {"max_seqs": 2, "max_len": 32, "page_size": 8, **kw}


def _dense(**over):
    """minicpm (dense MHA), heads lifted to divide a 4-way model axis."""
    return "minicpm-2b", {"block": 8, "n_heads": 8, "n_kv_heads": 8, **over}


def _twins():
    vocab = 512
    shared = np.random.default_rng(21).integers(0, vocab, size=(24,)).astype(np.int32)
    tail = np.random.default_rng(22).integers(0, vocab, size=(3,)).astype(np.int32)
    cases = []
    for backend in ("cuda", "reference"):
        arch, over = _dense(decode_backend=backend)
        cases.append(dict(name=f"dense_chunked_{backend}", arch=arch, over=over,
                          prompts=_prompts(vocab, (12, 9, 14)), max_new=8, stagger=2,
                          ec=_ec(backend=backend)))
        cases.append(dict(name=f"mla_{backend}", arch="deepseek-v3-671b",
                          over={"block": 8, "decode_backend": backend},
                          prompts=_prompts(256, (8, 7, 6), seed=1), max_new=6, stagger=2,
                          ec=_ec(backend=backend)))
    arch, over = _dense()
    cases += [
        dict(name="server_waves", kind="server", arch=arch, over=over,
             prompts=_prompts(vocab, (12, 12)), max_new=8),
        dict(name="moe_stack", arch="granite-moe-3b-a800m",
             over={"block": 8, "n_heads": 8, "n_kv_heads": 4},
             prompts=_prompts(vocab, (8, 7, 6), seed=1), max_new=6, stagger=2, ec=_ec()),
        dict(name="preemption", arch=arch, over=dict(over, block=4),
             prompts=_prompts(vocab, (10, 10, 10)), max_new=10, stagger=0,
             ec={"max_seqs": 3, "max_len": 20, "page_size": 4, "num_pages": 9}),
        dict(name="cow", arch=arch, over=over,
             prompts=[np.concatenate([shared, tail]), shared[:20].copy()], max_new=8,
             stagger=4, ec=_ec(max_len=48)),
        dict(name="reject", kind="reject", arch="minicpm-2b", over={"block": 8},
             ec=_ec()),
        dict(name="data_axis", kind="data_axis", arch=arch, over=over, ec=_ec(),
             serve_mesh="2x2", prompts=_prompts(vocab, (12, 9, 14)), max_new=8, stagger=2),
    ]
    for c in cases:
        c.setdefault("kind", "engine")
        c.update(tp=4, params=None, jax=False)
    cases.append(dict(name="reject_constructs", kind="constructs", arch="minicpm-2b",
                      over={"block": 8}, ec=_ec(), tp=2, params=None, jax=False))
    # a padded vocab of 512 does not split 3 ways: embed falls back to its
    # d_model columns (tied to the head in minicpm; starcoder2's untied
    # lm_head stays whole on each rank)
    cases.append(dict(name="vocab_fallback_tied", arch="minicpm-2b", over={"block": 8},
                      prompts=_prompts(vocab, (12, 9, 14)), max_new=6, stagger=2, ec=_ec(),
                      kind="engine", tp=3, params=None, jax=False))
    cases.append(dict(name="vocab_fallback_untied", arch="starcoder2-7b",
                      over={"block": 8, "n_kv_heads": 3},
                      prompts=_prompts(vocab, (12, 9, 14)), max_new=6, stagger=2, ec=_ec(),
                      kind="engine", tp=3, params=None, jax=False))
    # 8 experts do not split 3 ways: each expert's hidden width does
    cases.append(dict(name="moe_hidden_fallback", arch="granite-moe-3b-a800m",
                      over={"block": 8, "n_kv_heads": 3, "moe_d_ff": 96},
                      prompts=_prompts(vocab, (8, 7, 6), seed=1), max_new=6, stagger=2,
                      ec=_ec(), kind="engine", tp=3, params=None, jax=False))
    # the vision frontend (static Server only): the image-prefix stubs and
    # M-RoPE's three streams on local heads
    cases.append(dict(name="vision_server", kind="server", arch="qwen2-vl-72b",
                      over={"block": 8}, prompts=_prompts(vocab, (12, 12), seed=5),
                      max_new=6, tp=2, params=None, jax=False))
    return cases


FAMILIES = {  # one per family the engine serves, stock smoke heads
    "gqa": "starcoder2-7b",
    "dense_mha": "minicpm-2b",
    "swa": "h2o-danube-3-4b",
    "mla_moe": "deepseek-v3-671b",
    "moe": "granite-moe-3b-a800m",
    "ssm": "mamba2-130m",
    "hymba": "hymba-1.5b",
    "whisper": "whisper-tiny",
}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _family_cases():
    """The weights: the port's ``init_params`` from seed 0, carried as numpy
    arrays to the ranks, the baseline and the JAX engine alike (the trees
    share keys, shapes and types)."""
    cases = []
    for name, arch in FAMILIES.items():
        cfg = dataclasses.replace(C.get_config(arch, smoke=True, dtype=torch.float32),
                                  block=8)
        params = _numpy(M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
        rng = np.random.default_rng(3)
        audio = None
        if cfg.n_encoder_layers:
            audio = [rng.standard_normal((1, cfg.encoder_seq, cfg.d_model),
                                         dtype=np.float32) for _ in range(3)]
        # the first prompt is one page: the JAX engine compiles one chunk shape
        cases.append(dict(name=f"family_{name}", kind="engine", arch=arch,
                          over={"block": 8}, params=params, tp=2, jax=True,
                          prompts=_prompts(cfg.vocab_size, (8, 9, 14), seed=4),
                          max_new=6, stagger=2, ec=_ec(max_len=48), audio=audio))
    return cases


def _cfg_params(case):
    cfg = dataclasses.replace(C.get_config(case["arch"], smoke=True, dtype=torch.float32),
                              **case["over"])
    if case["params"] is None:
        return cfg, M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, M.params_from_numpy(case["params"], device="cpu")


def _baseline(case):
    """The single-device port engine (or Server) on the case."""
    cfg, params = _cfg_params(case)
    if case["kind"] == "server":
        out = Server(cfg, params, ServeConfig(max_len=64), device="cpu").generate(
            {"tokens": np.stack(case["prompts"])}, case["max_new"])
        return {"tokens": list(out), "cfg": cfg, "params": params}
    eng = Engine(cfg, params, EngineConfig(**case["ec"]), device="cpu")
    audio = case.get("audio")
    for i, p in enumerate(case["prompts"]):
        eng.submit(p, case["max_new"], rid=i, arrival_step=case["stagger"] * i,
                   extras=None if audio is None else {"audio_embeds": audio[i]})
    reqs = eng.run()
    return {"tokens": [np.asarray(r.out_tokens, np.int32) for r in reqs],
            "bytes": eng.kv.cache_bytes(), "data": eng.kv.data, "cfg": cfg,
            "params": params}


def _jax_first_logits(case):
    """The JAX single-device engine's first decode logits: its first step,
    which admits, prefills and decodes the first request alone (as every
    engine here does on this schedule)."""
    jcfg = dataclasses.replace(JC.get_config(case["arch"], smoke=True, dtype=jnp.float32),
                               **case["over"])
    eng = JEngine(jcfg, jax.tree.map(jnp.asarray, case["params"]),
                  JEngineConfig(**case["ec"], backend="reference"))
    got = []
    decode = eng._decode

    def recording(*args):
        out = decode(*args)
        got.append(np.asarray(out[1]))
        return out

    eng._decode = recording
    audio = case.get("audio")
    eng.submit(case["prompts"][0], case["max_new"], rid=0,
               extras=None if audio is None else {"audio_embeds": audio[0]})
    while not got:
        eng.step()
    return got[0]


def _start_ranks(cases_path, tmp, tp):
    d = tmp / f"tp{tp}"
    d.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = []
    for r in range(tp):
        log = open(d / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(HELPER), str(cases_path), str(d / "store"), str(r), str(tp),
             str(d)], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return d, procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    cases = _twins() + _family_cases()
    cases_path = tmp / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    started = {tp: _start_ranks(cases_path, tmp, tp) for tp in (2, 3, 4)}
    # meanwhile: the baselines in this process
    base = {c["name"]: _baseline(c) for c in cases
            if c["kind"] in ("engine", "server", "data_axis")}
    jax_logits = {c["name"]: _jax_first_logits(c) for c in cases if c["jax"]}
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    ranks = {}
    try:
        for tp, (d, procs) in started.items():
            for r, (p, log) in enumerate(procs):
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                log.close()
                assert rc == 0, f"TP {tp} rank {r} exited {rc}:\n" + \
                    (d / f"rank{r}.log").read_text()[-4000:]
            ranks[tp] = [pickle.loads((d / f"rank{r}.pkl").read_bytes())
                         for r in range(tp)]
    finally:
        for _d, procs in started.values():
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    return SimpleNamespace(cases={c["name"]: c for c in cases}, base=base, jax=jax_logits,
                           ranks=ranks)


def _results(runs, name):
    case = runs.cases[name]
    out = [rk[name] for rk in runs.ranks[case["tp"]]]
    for r, o in enumerate(out):
        assert "exception" not in o, f"rank {r}:\n{o['exception']}"
    return case, out


def _margin(cfg, params, prompt, want, i, audio=None):
    """The baseline's top-2 logit margin at generated step ``i``, stepping
    the port's prefill and decode along its own tokens."""
    srv = Server(cfg, params, ServeConfig(max_len=64), device="cpu")
    batch = {"tokens": torch.from_numpy(prompt[None])}
    if audio is not None:
        batch["audio_embeds"] = torch.from_numpy(audio)
    logits, caches = M.prefill(cfg, params, batch)
    caches = srv._grow_cache(caches, 1, len(prompt))
    for j in range(i):
        tok = torch.tensor([[int(want[j])]])
        logits, caches = M.decode_step(cfg, params, caches, tok, len(prompt) + j)
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return float(top2[0] - top2[1])


def _check_tokens(runs, name):
    """Every rank's tokens equal the baseline's, or diverge where its
    margin is below MARGIN (counted); identical across ranks.  Returns the
    excused count."""
    case, out = _results(runs, name)
    base = runs.base[name]
    for r in out[1:]:
        for a, b in zip(r["tokens"], out[0]["tokens"]):
            np.testing.assert_array_equal(a, b)  # the same on every rank
    excused = 0
    for rid, (mine, want) in enumerate(zip(out[0]["tokens"], base["tokens"])):
        if np.array_equal(mine, want):
            continue
        i = int(np.argmax(np.asarray(mine) != np.asarray(want)))
        audio = case.get("audio")
        margin = _margin(base["cfg"], base["params"], case["prompts"][rid], want, i,
                         None if audio is None else audio[rid])
        assert margin < MARGIN, f"{name}: request {rid} diverges at {i}, margin {margin}"
        excused += 1
    print(f"{name}: {excused} divergences excused by the margin rule")
    return excused


def _expected_bytes(case, base):
    """Per-rank pool bytes from the adapters' specs: 1/M of a head-sharded
    leaf, all of a replicated one."""
    tp = case["tp"]
    specs = SH.paged_cache_pspecs(base["cfg"], abstract_mesh((1, tp), ("data", "model")),
                                  base["data"])

    def walk(data, spec):
        if isinstance(data, dict):
            return sum(walk(data[k], spec[k]) for k in data)
        nbytes = data.numel() * data.element_size()
        return nbytes // tp if any(e is not None for e in spec) else nbytes

    return walk(base["data"], specs)


# --------------------------------------------------------------------------
# The twins of tests/test_mesh_serve.py (TP 4)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_mesh_parity_dense_chunked_prefill(runs, backend):
    """Dense paged pools head-shard 4-way; chunked admission, slot re-fill
    and both decode backends match the single-device engine, and each rank
    holds 1/4 of the pool (minicpm's pools are all head-sharded)."""
    name = f"dense_chunked_{backend}"
    assert _check_tokens(runs, name) == 0
    _, out = _results(runs, name)
    for r in out:
        assert r["bytes_per_device"] == r["bytes"] // 4 == runs.base[name]["bytes"] // 4


def test_mesh_parity_server_static_waves(runs):
    """The static-wave Server on the same mesh: the same greedy tokens."""
    assert _check_tokens(runs, "server_waves") == 0


def test_mesh_parity_vision_server(runs):
    """qwen2-vl's static Server on a 1 x 2 mesh (the engine has no cache
    adapter for it): the same greedy tokens."""
    assert _check_tokens(runs, "vision_server") == 0


@pytest.mark.parametrize("tied", ["tied", "untied"])
def test_vocab_that_does_not_split_falls_back(runs, tied):
    """TP 3 on a 512-token padded vocab: the embedding shards its d_model
    columns instead (the JAX rules' fallback), the tied head sums partial
    products, an untied head stays whole; the tokens match one device."""
    assert _check_tokens(runs, f"vocab_fallback_{tied}") == 0


def test_moe_experts_that_do_not_split_shard_their_hidden_width(runs):
    """TP 3 on 8 experts: every rank multiplies every expert's slots on its
    third of the hidden width (the JAX rules' fallback); same tokens."""
    assert _check_tokens(runs, "moe_hidden_fallback") == 0


def test_mesh_parity_moe_stack(runs):
    """MoE (granite): 8 experts, 2 a rank (expert parallelism), GQA pools
    head-sharded; single-chunk prompts keep the capacity dispatch one-shot."""
    assert _check_tokens(runs, "moe_stack") == 0


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_mesh_parity_mla_latent_pages(runs, backend):
    """DeepSeek MLA at its stock 2 heads on a 4-way axis: latent pools
    replicate (no head axis), every rank holds the whole pool and runs the
    whole attention (its heads do not split), the MoE and FFN stay sharded,
    and the tokens match."""
    name = f"mla_{backend}"
    assert _check_tokens(runs, name) == 0
    _, out = _results(runs, name)
    for r in out:
        assert r["bytes_per_device"] == r["bytes"] == runs.base[name]["bytes"]


def test_mesh_preemption_recompute_parity(runs):
    """LIFO preemption and re-prefill over head-sharded pools."""
    assert _check_tokens(runs, "preemption") == 0
    _, out = _results(runs, "preemption")
    assert all(r["preemptions"] >= 1 for r in out)


def test_mesh_shared_prefix_cow_parity(runs):
    """Prefix aliasing and copy-on-write across sharded pools: the page
    copy runs on each rank's pool slice."""
    assert _check_tokens(runs, "cow") == 0
    _, out = _results(runs, "cow")
    assert all(r["cow_copies"] >= 1 and r["pages_aliased"] >= 1 for r in out)


def test_mesh_rejects_nondividing_kv_heads(runs):
    """6 kv heads on a 4-way model axis raise at construction, before a
    shard or a pool is cut, with the JAX package's message; 2-way
    constructs; the same four ranks as a 2 x 2 mesh (a data axis of 2)
    serve the single device's tokens."""
    _, out = _results(runs, "reject")
    for r in out:
        assert r["error"] is not None
        assert "n_kv_heads=6" in r["error"] and "model-axis size 4" in r["error"]
    _, out = _results(runs, "reject_constructs")
    assert all(r["bytes_per_device"] > 0 for r in out)
    assert _check_tokens(runs, "data_axis") == 0


# --------------------------------------------------------------------------
# One case per family (TP 2, the same weights in both packages)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_tensor_parallel(runs, family):
    name = f"family_{family}"
    case, out = _results(runs, name)
    excused = _check_tokens(runs, name)
    # a routed stack may flip a near-tie of its router (counted, margin-ruled)
    assert excused == 0 or FAMILIES[family] in ("granite-moe-3b-a800m", "deepseek-v3-671b")
    want = _expected_bytes(case, runs.base[name])
    for r in out:
        assert r["bytes_per_device"] == want
        assert r["bytes"] == runs.base[name]["bytes"]
    # the first decode step (the first request alone, slot 0) against the
    # JAX single-device engine, over the real vocabulary
    V = C.get_config(case["arch"], smoke=True).vocab_size
    mine = out[0]["first_logits"][0, -1, :V]
    theirs = runs.jax[name][0, -1, :V]
    np.testing.assert_allclose(mine, theirs, atol=LOGIT_TOL, rtol=0)


# --------------------------------------------------------------------------
# The paged kernels on a rank's local heads (no process group)
# --------------------------------------------------------------------------

def _decode_operands(dtype, B=3, H=8, hkv=4, dh=16, page=8, maxp=4, pages=10):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, 1, H, dh, generator=g).to(dtype)
    k = torch.randn(pages, page, hkv, dh, generator=g).to(dtype)
    v = torch.randn(pages, page, hkv, dh, generator=g).to(dtype)
    table = torch.randint(1, pages, (B, maxp), generator=g, dtype=torch.int32)
    table[0, 2:] = 0  # unmapped entries on the null page
    seq = torch.tensor([10, 31, 0], dtype=torch.int32)
    return q, k, v, table, seq


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_on_local_heads_is_the_head_slice(dtype, tp):
    """A rank's H/M query heads over its Hkv/M kv heads give the head slice
    of the whole call, bit for bit (attention is head-independent)."""
    q, k, v, table, seq = _decode_operands(dtype)
    full = PA.paged_attention_decode(q, k, v, table, seq)
    hq, hk = q.shape[2] // tp, k.shape[2] // tp
    for r in range(tp):
        part = PA.paged_attention_decode(q[:, :, r * hq:(r + 1) * hq].contiguous(),
                                         k[:, :, r * hk:(r + 1) * hk].contiguous(),
                                         v[:, :, r * hk:(r + 1) * hk].contiguous(), table, seq)
        assert torch.equal(part, full[:, :, r * hq:(r + 1) * hq])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_on_local_heads_is_the_head_slice(dtype, tp):
    g = torch.Generator().manual_seed(1)
    B, H, r, dr, page, maxp, pages = 2, 8, 32, 8, 8, 3, 7
    q_lat = torch.randn(B, 1, H, r, generator=g).to(dtype)
    q_rope = torch.randn(B, 1, H, dr, generator=g).to(dtype)
    ckv = torch.randn(pages, page, r, generator=g).to(dtype)
    kr = torch.randn(pages, page, dr, generator=g).to(dtype)
    table = torch.randint(1, pages, (B, maxp), generator=g, dtype=torch.int32)
    seq = torch.tensor([5, 20], dtype=torch.int32)
    full = PA.mla_paged_attention_decode(q_lat, q_rope, ckv, kr, table, seq, scale=0.1)
    h = H // tp
    for rk in range(tp):
        part = PA.mla_paged_attention_decode(
            q_lat[:, :, rk * h:(rk + 1) * h].contiguous(),
            q_rope[:, :, rk * h:(rk + 1) * h].contiguous(), ckv, kr, table, seq, scale=0.1)
        assert torch.equal(part, full[:, :, rk * h:(rk + 1) * h])


@pytest.mark.parametrize("tp", [2, 4])
def test_paged_copy_on_a_rank_slice_is_the_slice_of_the_copy(tp):
    pool = torch.randn(2, 6, 4, 8, 16, generator=torch.Generator().manual_seed(2))
    whole = PA.paged_copy(pool.clone(), 3, 5)
    n = pool.shape[3] // tp
    for r in range(tp):
        mine = PA.paged_copy(pool[:, :, :, r * n:(r + 1) * n].contiguous(), 3, 5)
        assert torch.equal(mine, whole[:, :, :, r * n:(r + 1) * n])


def test_decode_plans_read_no_head_count():
    """The key splits are fixed: neither plan takes a head count, so a
    rank's launch runs the unsharded launch's splits on its heads."""
    assert list(inspect.signature(PA.decode_plan).parameters) == ["page", "maxp"]
    assert list(inspect.signature(PA.mla_decode_plan).parameters) == ["page", "maxp", "dtype"]


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def test_mesh_entry_points_refuse_what_is_not_a_mesh():
    from repro_torch.launch import mesh as LM

    cfg = C.get_config("minicpm-2b", smoke=True, dtype=torch.float32)
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(cfg, params, EngineConfig(), mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="no ranks"):
        Engine(cfg, params, EngineConfig(), mesh=abstract_mesh((2, 2), ("data", "model")),
               device="cpu")
    with pytest.raises(TypeError, match="no ranks"):
        Server(cfg, params, ServeConfig(), mesh=abstract_mesh((1, 2), ("data", "model")),
               device="cpu")
    with pytest.raises(ValueError, match="expects DxM"):
        LM.parse_mesh("2by2")
    with pytest.raises(RuntimeError, match="no process group"):
        LM.make_serve_mesh("1x2")
    with pytest.raises(NotImplementedError, match="item 27"):
        LM.make_production_mesh()


def test_chip_smoke_tp_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 15 on the CPU at smoke size (its kernels'
    plain versions, no launch gates): the same spawn, the per-rank
    head-slice checks, and the token, step and pool-byte gates."""
    import repro_torch.kernels as kernels

    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke as cs

    ec = {"max_seqs": 4, "max_len": 1024, "page_size": 128, "prefill_chunk": 128}
    dense = dict(n_layers=2, family="dense", n_experts=0, n_shared_experts=0, top_k=0,
                 moe_d_ff=0, first_k_dense=0, mtp_depth=0)
    smoke = lambda arch, **kw: C.get_config(arch, smoke=True, **kw)  # noqa: E731
    models = {
        "starcoder2-7b": (smoke("starcoder2-7b", dtype=torch.float32), ec),
        "deepseek-v3 dense prefix": (dataclasses.replace(
            smoke("deepseek-v3-671b", dtype=torch.float32), **dense), ec),
        "granite-moe-3b-a800m": (smoke("granite-moe-3b-a800m", dtype=torch.float32),
                                 dict(ec, chunked_prefill=False)),
    }
    out, checked = cs.tp_serve_phase(torch, kernels, device_type="cpu", models=models,
                                     timing=smoke("starcoder2-7b", dtype=torch.bfloat16))
    assert set(out) == set(models)
    assert checked == {}  # the kernels' checks against plain run on the card only
    assert out["deepseek-v3 dense prefix"]["mla_calls_per_rank"] == [
        2 * n for n in out["deepseek-v3 dense prefix"]["decode_steps"]]
    for line in out.values():
        assert line["excused"] == {"margin": 0, "router": 0}
        assert line["decode_steps"] == [line["decode_steps_one_device"]] * 2


def test_cli_mesh_serves_the_same_tokens():
    """``--mesh 1x2`` spawns its two ranks; rank 0 prints the same tokens
    as the single-device run."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "starcoder2-7b",
            "--smoke", "--device", "cpu", "--max-new", "12"]
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in (base, base + ["--mesh", "1x2"])]
    try:
        (one, one_err), (two, two_err) = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert procs[0].returncode == 0, one_err[-2000:]
    assert procs[1].returncode == 0, two_err[-2000:]
    one, two = SimpleNamespace(stdout=one), SimpleNamespace(stdout=two)
    assert "serving on mesh 1x2: 1 data x 2 model" in two.stdout
    assert two.stdout.count("generated") == 1  # rank 0 alone prints
    tokens = lambda out: out[out.index("[["):]  # noqa: E731
    assert tokens(two.stdout) == tokens(one.stdout)
