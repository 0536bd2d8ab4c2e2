"""Serving on a data x model mesh: ``gloo`` ranks on the CPU against the
port's single-device engine and the JAX package's.

The twins of ``tests/test_mesh_serve.py`` (dense chunked prefill on both
backends, ``Server`` static waves, the MoE stack, MLA latent pages,
preemption and recompute, shared-prefix copy-on-write, the non-dividing
rejection) run on a ``2 x 2`` mesh, each rank drawing its shares of the
weights from the seed (``init_params(layout=ServeLayout)``): the JAX serve
mode's weights, resident and split over all four ranks, the pools over the
model axis only.  One case a family the engine serves runs on the same mesh
with the full weights carried as numpy arrays to both packages (each rank
keeps its shares); a few run again on ``2 x 1``.  A ``d_ff`` that the four
ranks do not split takes the serve mode's 2-D fallback, gathered before
each step.  Every rank's tokens must equal the single-device port engine's
(a divergence is excused only where the baseline's top-2 logit margin is
below ``MARGIN``, and the excused ones are counted) and be the same on
every rank; each rank stores exactly the JAX serve spec's share of each
leaf (its kept-whole leaves whole) and 1/M of a head-sharded pool; the
family cases' first decode logits lie within ``LOGIT_TOL`` of the JAX
single-device engine's.

One module-scoped fixture starts the ranks once per mesh
(``tests/torch_mesh_ranks.py``, one process a rank, a ``FileStore`` in the
test's temporary directory, 60 s collective timeouts) and computes the
baselines while they run.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_mesh_serve import (
    FAMILIES,
    HELPER,
    LOGIT_TOL,
    MARGIN,
    REPO,
    _baseline,
    _dense,
    _ec,
    _jax_first_logits,
    _margin,
    _numpy,
    _prompts,
)

import repro_torch.configs as C
from repro_torch.models import model as M

RANKS_TIMEOUT_S = 240  # the ranks' own collectives time out after 60 s
MESHES = ("2x2", "2x1")
ON_2X1 = ("dense_chunked_cuda", "mla_cuda", "moe_stack", "family_whisper")


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
        # DeepSeek-V3's stock 2 heads: one a model slice, so wkv_b's quarter
        # splits a head and is gathered into the model slice each step
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
        # a hidden width of 42 splits 2 ways, not 4: the 2-D fallback
        dict(name="fallback", arch="starcoder2-7b", over={"block": 8, "d_ff": 42},
             prompts=_prompts(vocab, (12, 9, 14)), max_new=6, stagger=2, ec=_ec()),
        # 3 kv heads on a model axis of 2
        dict(name="reject", kind="reject", arch="starcoder2-7b",
             over={"block": 8, "n_kv_heads": 3}, ec=_ec()),
    ]
    for c in cases:
        c.setdefault("kind", "engine")
        c.update(mesh="2x2", params=None, jax=False,
                 draw=None if c["kind"] == "reject" else "shards")
    return cases


def _family_cases():
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
        cases.append(dict(name=f"family_{name}", kind="engine", arch=arch,
                          over={"block": 8}, params=params, mesh="2x2", jax=True,
                          prompts=_prompts(cfg.vocab_size, (8, 9, 14), seed=4),
                          max_new=6, stagger=2, ec=_ec(max_len=48), audio=audio))
    return cases


def _all_cases():
    cases = _twins() + _family_cases()
    again = [dict(c, name=f"{c['name']}@2x1", mesh="2x1", jax=False)
             for c in cases if c["name"] in ON_2X1]
    return cases + again


def _start_ranks(cases_path, tmp, spec):
    d = tmp / spec
    d.mkdir()
    world = int(np.prod([int(n) for n in spec.split("x")]))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(d / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(HELPER), str(cases_path), str(d / "store"), str(r),
             str(world), str(d), spec], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return d, procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cases = _all_cases()
    cases_path = tmp / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    started = {spec: _start_ranks(cases_path, tmp, spec) for spec in MESHES}
    # meanwhile: the baselines in this process (a 2 x 1 case's is its twin's)
    base = {c["name"]: _baseline(c) for c in cases
            if c["kind"] in ("engine", "server") and c["mesh"] == "2x2"}
    jax_logits = {c["name"]: _jax_first_logits(c) for c in cases if c["jax"]}
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    ranks = {}
    try:
        for spec, (d, procs) in started.items():
            for r, (p, log) in enumerate(procs):
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                log.close()
                assert rc == 0, f"{spec} rank {r} exited {rc}:\n" + \
                    (d / f"rank{r}.log").read_text()[-4000:]
            ranks[spec] = [pickle.loads((d / f"rank{r}.pkl").read_bytes())
                           for r in range(len(procs))]
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
    out = [rk[name] for rk in runs.ranks[case["mesh"]]]
    for r, o in enumerate(out):
        assert "exception" not in o, f"rank {r}:\n{o['exception']}"
    return case, out


def _check(runs, name):
    """Every rank's tokens equal the baseline's, or diverge where its margin
    is below MARGIN (counted); identical across ranks; each rank stores the
    serve spec's share of every leaf.  Returns the excused count."""
    case, out = _results(runs, name)
    base = runs.base[name.split("@")[0]]
    for r in out[1:]:
        for a, b in zip(r["tokens"], out[0]["tokens"]):
            np.testing.assert_array_equal(a, b)  # the same on every rank
    for r in out:
        if "param_bytes" in r:
            assert r["param_bytes"] == r["param_bytes_by_spec"]
            assert r["placed_tree_kept"] == (case.get("draw") == "shards")
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


# --------------------------------------------------------------------------
# The twins of tests/test_mesh_serve.py (2 x 2, drawn by shards)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_dp_parity_dense_chunked_prefill(runs, backend):
    """Dense paged pools head-shard over the model axis, replicated over
    data: each rank holds 1/2 of the pool; chunked admission and both decode
    backends match the single-device engine, on 2 x 2 and on 2 x 1."""
    for name in (f"dense_chunked_{backend}",) + (("dense_chunked_cuda@2x1",)
                                                 if backend == "cuda" else ()):
        assert _check(runs, name) == 0
        case, out = _results(runs, name)
        m = int(case["mesh"].split("x")[1])
        for r in out:
            assert r["bytes_per_device"] == runs.base[name.split("@")[0]]["bytes"] // m
            assert r["gathered"] == []  # every leaf read as it is stored


def test_dp_parity_server_static_waves(runs):
    assert _check(runs, "server_waves") == 0


def test_dp_parity_moe_stack(runs):
    """granite's 8 experts, 2 a rank on 2 x 2 (4 on 2 x 1): the dispatch on
    every rank, the gated outputs summed over all of them."""
    assert _check(runs, "moe_stack") == 0
    assert _check(runs, "moe_stack@2x1") == 0


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_dp_parity_mla_latent_pages(runs, backend):
    """MLA latent pools replicate: every rank holds the whole pool; the
    tokens match on both meshes."""
    names = (f"mla_{backend}",) + (("mla_cuda@2x1",) if backend == "cuda" else ())
    for name in names:
        assert _check(runs, name) == 0
        _, out = _results(runs, name)
        for r in out:
            assert r["bytes_per_device"] == r["bytes"] == runs.base[f"mla_{backend}"]["bytes"]
    _, out = _results(runs, f"mla_{backend}")
    assert all(any(g.endswith("attn/wkv_b") for g in r["gathered"]) for r in out)


def test_dp_preemption_recompute_parity(runs):
    assert _check(runs, "preemption") == 0
    _, out = _results(runs, "preemption")
    assert all(r["preemptions"] >= 1 for r in out)


def test_dp_shared_prefix_cow_parity(runs):
    assert _check(runs, "cow") == 0
    _, out = _results(runs, "cow")
    assert all(r["cow_copies"] >= 1 and r["pages_aliased"] >= 1 for r in out)


def test_dp_two_dimensional_fallback_is_gathered_each_step(runs):
    """d_ff 42 splits over the model axis, not over all four ranks: the
    serve mode stores w_up and b_up 2-D (data x model) and w_down by
    (data, model) rows and columns; each is gathered into the 1 x M slice
    before each step, and the tokens match."""
    assert _check(runs, "fallback") == 0
    _, out = _results(runs, "fallback")
    for r in out:
        assert sorted(g.split("/", 1)[1] for g in r["gathered"]) == [
            "ffn/b_up", "ffn/w_down", "ffn/w_up"]


def test_dp_rejects_nondividing_kv_heads(runs):
    """3 kv heads on a model axis of 2 raise at construction, before a
    shard or a pool is cut, with the JAX package's message."""
    _, out = _results(runs, "reject")
    for r in out:
        assert r["error"] is not None
        assert "n_kv_heads=3" in r["error"] and "model-axis size 2" in r["error"]


# --------------------------------------------------------------------------
# One case per family (2 x 2, the same weights in both packages)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_dp_family(runs, family):
    name = f"family_{family}"
    case, out = _results(runs, name)
    excused = _check(runs, name)
    # a routed stack may flip a near-tie of its router (counted, margin-ruled)
    assert excused == 0 or FAMILIES[family] in ("granite-moe-3b-a800m", "deepseek-v3-671b")
    for r in out:
        assert r["bytes"] == runs.base[name]["bytes"]
    V = C.get_config(case["arch"], smoke=True).vocab_size
    np.testing.assert_allclose(out[0]["first_logits"][0, -1, :V], runs.jax[name][0, -1, :V],
                               atol=LOGIT_TOL, rtol=0)
    if f"{name}@2x1" in runs.cases:
        assert _check(runs, f"{name}@2x1") == 0


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def test_cli_mesh_2x2_serves_the_same_tokens():
    """``--mesh 2x2`` spawns its four ranks, each drawing its shards; rank
    0 prints the same tokens as the single-device run."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "starcoder2-7b",
            "--smoke", "--device", "cpu", "--max-new", "12"]
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in (base, base + ["--mesh", "2x2"])]
    try:
        (one, one_err), (two, two_err) = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert procs[0].returncode == 0, one_err[-2000:]
    assert procs[1].returncode == 0, two_err[-2000:]
    assert "serving on mesh 2x2: 2 data x 2 model" in two
    assert "drawn by shards" in two
    assert two.count("generated") == 1  # rank 0 alone prints
    tokens = lambda out: out[out.index("[["):]  # noqa: E731
    assert tokens(two) == tokens(one)


def test_chip_smoke_dp_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 17 on the CPU at smoke size (its kernels'
    plain versions, no launch or memory gates): the same four spawned ranks
    on 2 x 2, each drawing its shards, and the token, step, parameter-byte
    and pool-byte gates."""
    import repro_torch.kernels as kernels

    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke as cs

    ec = {"max_seqs": 4, "max_len": 1024, "page_size": 128, "prefill_chunk": 128}
    smoke = lambda arch, **kw: C.get_config(arch, smoke=True, **kw)  # noqa: E731
    models = {
        "starcoder2-7b": (smoke("starcoder2-7b", dtype=torch.float32, n_layers=1), ec),
        "granite-moe-3b-a800m": (smoke("granite-moe-3b-a800m", dtype=torch.float32,
                                       n_layers=1), dict(ec, chunked_prefill=False)),
    }
    out = cs.dp_serve_phase(torch, kernels, device_type="cpu", models=models)
    assert set(out) == set(models)
    for line in out.values():
        assert line["excused"] == {"margin": 0, "router": 0}
        assert line["decode_steps"] == [line["decode_steps_one_device"]] * cs.DP_RANKS
        assert line["param_bytes_per_rank"] == line["param_bytes_by_spec"]
        assert max(line["param_bytes_per_rank"]) < line["full_tree_bytes"]
