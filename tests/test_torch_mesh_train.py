"""The port's trainer on a data x model mesh: ``gloo`` ranks on the CPU
against the port's single-device ``Trainer`` and the JAX ``Trainer``.

One module-scoped fixture starts the ranks once per mesh shape (``2 x 1``,
``1 x 2``, ``2 x 2``; ``tests/torch_mesh_train_ranks.py``, one process a
rank, a ``FileStore`` in the test's temporary directory, every group with a
timeout) and meanwhile runs the references in this process: the JAX
``Trainer`` on ``make_local_mesh()`` and the port's single-device
``Trainer``, every run from the JAX trainer's initial state (handed over
through a JAX checkpoint at step 0, the route of
``test_torch_system.py::test_trainer_history_matches_jax_trainer``).

The cases: minicpm at ``_tiny_cfg``'s widths with the real
``REPLICATE_BELOW`` (every leaf replicated: pure DP) and with it patched to
0 in the ranks (TP over ``model``, ZeRO over ``data``), on every mesh;
granite-moe and DeepSeek-V3 smoke (TP + EP, MLA, MTP) at ``1 x 2`` and
``2 x 1``; accumulation and the int8 round trip.  Every rank's loss history
must be the same, within 1e-5 relative of both references, and the final
parameters within rtol 1e-4 / atol 1e-5.  Then each rank's stored shapes
against the JAX train-mode specs, the draw by shards, ``compressed_psum``
against JAX's under ``vmap``, the batches' rows, the MoE's share of the
global dispatch grid, checkpoints across meshes and packages, and the CLI.
"""
import contextlib
import os
import pickle
import shutil
import subprocess
import sys
import time
import unittest.mock as mock
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.optim as JO
import repro_torch.configs as C
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.distributed import sharding as JSH
from repro.distributed.axes import abstract_mesh as j_abstract_mesh
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train.compression import compressed_psum as j_compressed_psum
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.axes import abstract_mesh
from repro_torch.models import ffn
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).resolve().parent / "torch_mesh_train_ranks.py"
RANKS_TIMEOUT_S = 240  # the ranks' own collectives time out after 60 s
MESHES = ("2x1", "1x2", "2x2")
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
            vocab_size=256)
RUN = dict(steps=3, batch=8, seq=32, lr=3e-3)
MODELS = {"dense": ("minicpm-2b", TINY), "granite": ("granite-moe-3b-a800m", {}),
          "deepseek": ("deepseek-v3-671b", {}), "starcoder2": ("starcoder2-7b", {})}


def _trainer_cases():
    cases = []
    for mesh in MESHES:
        for zero in (False, True):
            cases.append(dict(name=f"dense_{'zero' if zero else 'replicated'}_{mesh}",
                              model="dense", mesh=mesh, zero=zero))
    for model in ("granite", "deepseek"):
        for mesh in ("1x2", "2x1"):
            cases.append(dict(name=f"{model}_{mesh}", model=model, mesh=mesh, zero=True))
    cases.append(dict(name="dense_accum_2x1", model="dense", mesh="2x1", zero=True,
                      accum=2, jax=False))
    cases.append(dict(name="dense_int8_1x2", model="dense", mesh="1x2", zero=True,
                      int8="int8", jax=False))
    # starcoder2's biases are (L, width): ZeRO splits their layer axis, so
    # each stack is gathered whole before it is cut into layers
    cases.append(dict(name="starcoder2_2x2", model="starcoder2", mesh="2x2", zero=True,
                      jax=False))
    for c in cases:
        arch, over = MODELS[c["model"]]
        c.update(kind="trainer", arch=arch, over=over, **RUN)
        c.setdefault("jax", True)
    return cases


TRAINER_CASES = _trainer_cases()
CKPT_CASE = "dense_zero_2x2"  # its final checkpoint: restored elsewhere


def _jcfg(model):
    arch, over = MODELS[model]
    return JC.get_config(arch, smoke=True, dtype=jnp.float32, **over)


def _cfg(model):
    arch, over = MODELS[model]
    return C.get_config(arch, smoke=True, dtype=torch.float32, **over)


def _single_device(case, ckpt):
    """The port's single-device Trainer on the case (accumulation and int8
    as the case has them), from the JAX initial state in ``ckpt``."""
    cfg = _cfg(case["model"])
    tc = TrainerConfig(steps=RUN["steps"], checkpoint_every=0, log_every=1,
                       checkpoint_dir=ckpt, accum_steps=case.get("accum", 1),
                       grad_compression=case.get("int8"))
    params, _, hist = Trainer(cfg, None, tc, OptConfig(lr=RUN["lr"]), device="cpu").fit(
        SyntheticLMData(cfg, global_batch=RUN["batch"], seq_len=RUN["seq"]))
    return {"history": [h["loss"] for h in hist],
            "params": {path: x.numpy() for path, x in SH.flat_items(params)}}


def _start(cases_path, tmp, mesh):
    d, m = (int(n) for n in mesh.split("x"))
    out = tmp / f"mesh{mesh}"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = []
    for r in range(d * m):
        log = open(out / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(HELPER), str(cases_path), str(out / "store"), str(r),
             str(d), str(m), str(out)], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return out, procs


def _cli(tmp):
    """The train CLI on the CPU, alone and under torch.distributed.run with
    --mesh local (2 ranks), started in the background."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--arch", "minicpm-2b", "--smoke", "--device",
            "cpu", "--steps", "11", "--batch", "4", "--seq", "16"]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2"]
    return [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=tmp)
            for cmd in ([sys.executable] + args, run + args + ["--mesh", "local"])]


def _grads_for_psum(n):
    rng = np.random.default_rng(n)
    return [rng.standard_normal((n, 33, 17)).astype(np.float32) * 0.01,
            rng.standard_normal((n, 65)).astype(np.float32)]


def _moe_inputs():
    cfg = C.get_config("granite-moe-3b-a800m", smoke=True, dtype=torch.float32,
                       capacity_factor=0.5)
    p = ffn.moe_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    p = {k: v.numpy() for k, v in p.items() if k != "shared"}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    return cfg, p, x, w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshtrain")
    cli = _cli(tmp)
    # the initial states: each JAX trainer's own, in a JAX checkpoint at step 0
    jtrainers, init = {}, {}
    for model in MODELS:
        jtr = JTrainer(_jcfg(model), make_local_mesh(),
                       JTrainerConfig(steps=RUN["steps"], checkpoint_every=0, log_every=1),
                       JO.OptConfig(lr=RUN["lr"]))
        init[model] = str(tmp / f"init_{model}")
        JCheckpointManager(init[model]).save(0, jtr.init_state(), blocking=True)
        jtrainers[model] = jtr

    def copy_init(model, name):
        dst = tmp / "ckpt" / name
        shutil.copytree(init[model], dst)
        return str(dst)

    cases = []
    for c in TRAINER_CASES:
        cases.append(dict(c, ckpt=copy_init(c["model"], c["name"])))
    ckpt_dir = next(c["ckpt"] for c in cases if c["name"] == CKPT_CASE)
    cases += [
        dict(name="draw_dense_2x2", kind="draw", mesh="2x2", arch="minicpm-2b", over=TINY,
             zero=True, seed=4),
        dict(name="draw_deepseek_1x2", kind="draw", mesh="1x2", arch="deepseek-v3-671b",
             over={}, zero=True, seed=4),
        dict(name="restore_1x2", kind="restore", mesh="1x2", arch="minicpm-2b", over=TINY,
             zero=True, ckpt=ckpt_dir, step=RUN["steps"], wait_s=150),
        dict(name="psum_2", kind="compressed", mesh="2x1", ranks=2, grads=_grads_for_psum(2)),
        dict(name="psum_3", kind="compressed", mesh="2x2", ranks=3, grads=_grads_for_psum(3)),
    ]
    for mesh in MESHES:
        cases.append(dict(name=f"batch_dense_{mesh}", kind="batch", mesh=mesh,
                          arch="minicpm-2b", over={}, batch=4, seq=12, steps=(0, 7)))
    cases.append(dict(name="batch_vision_2x1", kind="batch", mesh="2x1", arch="qwen2-vl-72b",
                      over={}, batch=4, seq=12, steps=(3,)))
    cases.append(dict(name="batch_small_2x1", kind="batch", mesh="2x1", arch="minicpm-2b",
                      over={}, batch=1, seq=12, steps=(0,)))
    mcfg, mp, mx, mw = _moe_inputs()
    cases.append(dict(name="moe_grid_2x1", kind="moe", mesh="2x1", arch="granite-moe-3b-a800m",
                      over={"capacity_factor": 0.5}, moe_params=mp, x=mx, w=mw))
    # the restore waits for the 2x2 checkpoint: every other 1x2 case first
    cases.sort(key=lambda c: c["kind"] == "restore")
    cases_path = tmp / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    started = {mesh: _start(cases_path, tmp, mesh) for mesh in MESHES}

    # meanwhile: the references in this process
    jax_runs = {}
    for model in {c["model"] for c in TRAINER_CASES if c["jax"]}:
        jtr = jtrainers[model]
        jparams, _, hist = jtr.fit(JSyntheticLMData(_jcfg(model), global_batch=RUN["batch"],
                                                    seq_len=RUN["seq"]))
        jax_runs[model] = {"history": [h["loss"] for h in hist],
                           "params": dict(SH.flat_items(jax.tree.map(np.asarray, jparams)))}
    single = {}
    for c in TRAINER_CASES:
        key = (c["model"], c.get("accum", 1), c.get("int8"))
        if key not in single:
            single[key] = _single_device(c, copy_init(c["model"], f"single_{len(single)}"))

    deadline = time.monotonic() + RANKS_TIMEOUT_S
    ranks = {}
    try:
        for mesh, (out, procs) in started.items():
            for r, (p, log) in enumerate(procs):
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                log.close()
                assert rc == 0, f"mesh {mesh} rank {r} exited {rc}:\n" + \
                    (out / f"rank{r}.log").read_text()[-4000:]
            ranks[mesh] = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
                           for r in range(len(procs))]
        cli_out = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) + (p.returncode,)
                   for p in cli]
    finally:
        for _out, procs in started.values():
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        for p in cli:
            if p.poll() is None:
                p.kill()
                p.wait()
    return SimpleNamespace(cases={c["name"]: c for c in cases}, ranks=ranks, jax=jax_runs,
                           single=single, cli=cli_out, moe=(mcfg, mp, mx, mw))


def _results(runs, name):
    case = runs.cases[name]
    out = [rk[name] for rk in runs.ranks[case["mesh"]]]
    for r, o in enumerate(out):
        assert "exception" not in o, f"rank {r}:\n{o['exception']}"
    return case, out


def _close_losses(got, want):
    assert len(got) == len(want) == RUN["steps"]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)


# --------------------------------------------------------------------------
# The trainer on every mesh, against both references
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c["name"] for c in TRAINER_CASES])
def test_mesh_trainer_matches_single_device_and_jax(runs, name):
    """Every rank logs the same global losses, within 1e-5 relative of the
    port's single-device Trainer and of the JAX Trainer, and the final
    parameters (gathered) meet rtol 1e-4 / atol 1e-5 against both."""
    case, out = _results(runs, name)
    for o in out[1:]:
        assert o["history"] == out[0]["history"]
    single = runs.single[(case["model"], case.get("accum", 1), case.get("int8"))]
    refs = [single] + ([runs.jax[case["model"]]] if case["jax"] else [])
    for ref in refs:
        _close_losses(out[0]["history"], ref["history"])
        assert set(out[0]["params"]) == set(ref["params"])
        for path, got in out[0]["params"].items():
            np.testing.assert_allclose(got, ref["params"][path], rtol=1e-4, atol=1e-5,
                                       err_msg=str(path))


@pytest.mark.parametrize("name", [c["name"] for c in TRAINER_CASES])
def test_stored_shards_are_the_jax_train_specs(runs, name):
    """Each rank stores the local shape of JAX's ``param_pspecs(mode="train")``
    for every leaf and of ``opt_pspecs`` for both moments, on an abstract
    mesh of the same shape (REPLICATE_BELOW patched alike), and its bytes
    are exactly its spec's share."""
    case, out = _results(runs, name)
    d, m = (int(n) for n in case["mesh"].split("x"))
    jcfg = _jcfg(case["model"])
    if case["model"] == "starcoder2":  # a layer axis split over data
        assert any(s[0] == "data" for p, s in out[0]["specs"].items() if p[0] == "seg0")
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jmesh = j_abstract_mesh((d, m), ("data", "model"))
    patch = (mock.patch.object(JSH, "REPLICATE_BELOW", 0) if case["zero"]
             else contextlib.nullcontext())
    with patch:
        jspecs = JSH.param_pspecs(jcfg, jmesh, shapes, mode="train")
        jopt = JSH.opt_pspecs(jcfg, jmesh, None, jspecs)
    sizes = {"data": d, "model": m}
    full = dict(SH.flat_items(jax.tree.map(lambda s: tuple(s.shape), shapes)))
    for which, tree in (("stored", jspecs), ("stored_m", jopt["m"]), ("stored_v", jopt["v"])):
        want = {}
        for path, spec in SH.flat_items(tree):
            local = list(full[path])
            for i, e in enumerate(tuple(spec)):
                for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
                    local[i] //= sizes[a]
            want[path] = tuple(local)
        for o in out:
            assert o[which] == want, which
    for o in out:
        specs = {path: tuple(s) for path, s in o["specs"].items()}
        assert specs == {path: tuple(s) for path, s in SH.flat_items(jspecs)}
        local, whole = o["bytes"]
        assert whole == sum(4 * int(np.prod(s)) for s in full.values())
        assert local == sum(4 * int(np.prod(s)) for s in o["stored"].values())
        assert o["bytes_m"] == o["bytes"]
    if case["zero"]:
        assert out[0]["bytes"][0] < out[0]["bytes"][1]  # ZeRO / TP: a share
    else:
        assert out[0]["bytes"][0] == out[0]["bytes"][1]  # replicated


# --------------------------------------------------------------------------
# Draw by shards, batches, compressed_psum, the MoE grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["draw_dense_2x2", "draw_deepseek_1x2"])
def test_draw_by_shards_is_the_slice_of_the_single_device_draw(runs, name):
    case, out = _results(runs, name)
    cfg = C.get_config(case["arch"], smoke=True, dtype=torch.float32, **case["over"])
    whole = dict(SH.flat_items(M.init_params(cfg, torch.Generator().manual_seed(case["seed"]),
                                              device="cpu")))
    d, m = (int(n) for n in case["mesh"].split("x"))
    mesh = abstract_mesh((d, m), ("data", "model"))
    split = 0
    for o in out:
        assert set(o["shards"]) == set(whole)
        for path, shard in o["shards"].items():
            want = SH.local_shard(whole[path], o["specs"][path], mesh, o["coords"]).numpy()
            np.testing.assert_array_equal(shard, want, err_msg=str(path))
            split += shard.shape != tuple(whole[path].shape)
    assert split  # some leaves are cut


@pytest.mark.parametrize("n", [2, 3])
def test_compressed_psum_matches_jax(runs, n):
    """The port's compressed_psum over n gloo ranks against the JAX
    package's under ``jax.vmap(..., axis_name=...)``, within one fp32 ulp."""
    case, out = _results(runs, f"psum_{n}")
    grads = case["grads"]
    want = jax.vmap(lambda *g: j_compressed_psum(list(g), "d"), axis_name="d")(
        *[jnp.asarray(g) for g in grads])
    for r in range(n):
        for got, w in zip(out[r]["out"], want):
            np.testing.assert_array_max_ulp(got, np.asarray(w)[r], maxulp=1)


@pytest.mark.parametrize("name", [f"batch_dense_{m}" for m in MESHES]
                         + ["batch_vision_2x1", "batch_small_2x1"])
def test_rank_batches_are_rows_of_the_jax_global_batch(runs, name):
    """A rank's batch is the rows of the JAX package's global batch that
    its data coordinate owns (all of them on a data axis of one rank, or
    for a batch the axis does not split), bit for bit."""
    case, out = _results(runs, name)
    jcfg = JC.get_config(case["arch"], smoke=True, dtype=jnp.float32, **case["over"])
    d = int(case["mesh"].split("x")[0])
    for step in case["steps"]:
        want = JSyntheticLMData(jcfg, global_batch=case["batch"], seq_len=case["seq"],
                                seed=2).batch(step)
        for o in out:
            got = o[step]
            assert set(got) == set(want)
            split = case["batch"] % d == 0 and d > 1
            b = case["batch"] // d if split else case["batch"]
            lo = o["coords"]["data"] * b if split else 0
            for k, v in want.items():
                v = np.asarray(v)
                if v.dtype.name == "bfloat16":
                    v = v.view(np.int16)
                rows = v[:, lo:lo + b] if k == "positions3" else v[lo:lo + b]
                np.testing.assert_array_equal(got[k], rows, err_msg=k)


def test_moe_rank_computes_its_share_of_the_global_grid(runs):
    """granite's MoE at capacity factor 0.5 (tokens drop) on a 2 x 1 mesh:
    each data rank's output rows, x-gradient rows, its share of the aux loss
    and of the router's gradient add up to the single device's over the
    global batch; the same rows dispatched alone would drop others."""
    cfg, p, x, w = runs.moe
    _, out = _results(runs, "moe_grid_2x1")
    xt = torch.from_numpy(x).requires_grad_(True)
    router = torch.from_numpy(p["router"]).clone().requires_grad_(True)
    params = {k: torch.from_numpy(v) for k, v in p.items()}
    y, aux = ffn.moe_forward(dict(params, router=router), cfg, xt)
    gx, gr = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, [xt, router])
    T = x.shape[0] * x.shape[1]
    assert ffn.moe_capacity(T, cfg) * cfg.n_experts < T * cfg.top_k  # drops happen
    np.testing.assert_allclose(sum(o["aux"] for o in out), float(aux.detach()), rtol=1e-6)
    np.testing.assert_allclose(sum(o["grouter"] for o in out), gr.numpy(), rtol=1e-5,
                               atol=1e-6)
    alone = []
    for o in out:
        lo, hi = o["rows"]
        np.testing.assert_allclose(o["out"], y.detach().numpy()[lo:hi], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["gx"], gx.numpy()[lo:hi], rtol=1e-5, atol=1e-6)
        mine, _ = ffn.moe_forward(params, cfg, torch.from_numpy(x[lo:hi]))
        alone.append(not np.allclose(mine.numpy(), y.detach().numpy()[lo:hi], atol=1e-6))
    assert any(alone)  # the trap: a rank's own rows alone give other drops


# --------------------------------------------------------------------------
# Checkpoints across meshes and packages
# --------------------------------------------------------------------------

def test_checkpoint_written_on_2x2_restores_on_one_device_on_1x2_and_in_jax(runs):
    """The 2 x 2 ZeRO run's final checkpoint holds the logical leaves: it
    restores bit for bit on one device (the gathered parameters and
    moments of the run), through the JAX CheckpointManager, and on a 1 x 2
    mesh each rank holds exactly its slices."""
    case, out = _results(runs, CKPT_CASE)
    cfg = _cfg("dense")
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    state = (params, adamw_init(params))
    step, (p, o) = CheckpointManager(case["ckpt"]).restore(state, step=RUN["steps"],
                                                           device="cpu")
    assert step == RUN["steps"] and int(o["step"]) == RUN["steps"]
    got_p, got_m = dict(SH.flat_items(p)), dict(SH.flat_items(o["m"]))
    for path, want in out[0]["params"].items():
        np.testing.assert_array_equal(got_p[path].numpy(), want, err_msg=str(path))
        np.testing.assert_array_equal(got_m[path].numpy(), out[0]["m"][path])
    jtree = jax.eval_shape(lambda: (JM.init_params(_jcfg("dense"), jax.random.PRNGKey(0)),
                                    JO.adamw_init(JM.init_params(_jcfg("dense"),
                                                                 jax.random.PRNGKey(0)))))
    jlike = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jtree)
    jstep, jback = JCheckpointManager(case["ckpt"]).restore(jlike, step=RUN["steps"])
    assert jstep == RUN["steps"]
    for a, b in zip(jax.tree.leaves(jback), T.leaves((p, o))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _, back = _results(runs, "restore_1x2")
    mesh = abstract_mesh((1, 2), ("data", "model"))
    split = 0
    for r in back:
        assert r["step"] == RUN["steps"] and r["opt_step"] == RUN["steps"]
        for path, shard in r["params"].items():
            want = SH.local_shard(got_p[path], r["specs"][path], mesh, r["coords"]).numpy()
            np.testing.assert_array_equal(shard, want, err_msg=str(path))
            wm = SH.local_shard(got_m[path], r["specs"][path], mesh, r["coords"]).numpy()
            np.testing.assert_array_equal(r["m"][path], wm)
            split += shard.shape != tuple(got_p[path].shape)
    assert split


# --------------------------------------------------------------------------
# The CLI, and what stays refused
# --------------------------------------------------------------------------

def test_cli_mesh_local_matches_the_single_process_run(runs):
    """``--mesh local`` under ``python -m torch.distributed.run
    --nproc-per-node 2``: rank 0 alone prints, and its final loss is the
    single process's within 1e-5 relative."""
    (one, one_err, rc1), (two, two_err, rc2) = runs.cli
    assert rc1 == 0, one_err[-2000:]
    assert rc2 == 0, two_err[-2000:]
    assert two.count("final loss") == 1 and "mesh 1x2" in two
    loss = lambda s: float(s[s.index("final loss: ") + 12:].split()[0])  # noqa: E731
    assert abs(loss(two) - loss(one)) <= 1e-5 * abs(loss(one))


def test_trainer_placement_is_train_mode_param_and_opt_pspecs():
    """``train_placement`` is exactly ``param_pspecs(mode="train")`` and
    ``opt_pspecs``, and the layout's per-leaf rule places the same specs
    as the leaves are drawn (an abstract mesh: shapes only)."""
    cfg = C.get_config("deepseek-v3-671b", smoke=True, dtype=torch.float32)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    with mock.patch.object(SH, "REPLICATE_BELOW", 0):
        params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        specs, opt = SH.train_placement(cfg, mesh, params)
        assert specs == SH.param_pspecs(cfg, mesh, params, mode="train")
        assert opt == {"m": specs, "v": specs, "step": ()}
        layout = SH.TrainLayout(cfg, mesh, coords={"data": 1, "model": 0})
        shards = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                               layout=layout)
        assert layout.specs(shards) == specs
    for path, leaf in SH.flat_items(shards):
        want = SH.local_shard(dict(SH.flat_items(params))[path],
                              dict(SH.flat_items(specs))[path], mesh,
                              {"data": 1, "model": 0})
        assert torch.equal(leaf, want), path


def test_chip_smoke_tp_train_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 16 on the CPU at smoke size (REPLICATE_BELOW 0
    in its ranks, so the small model shards): the same spawn, the loss,
    parameter, byte and checkpoint gates, no kernel launched."""
    import repro_torch.kernels as kernels

    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke as cs

    cfg = C.get_config("minicpm-2b", smoke=True, dtype=torch.float32, n_layers=2)
    out = cs.tp_train_phase(torch, kernels, device_type="cpu", cfg=cfg, replicate_below=0)
    assert set(out) == {"2x1", "1x2"}
    for line in out.values():
        assert line["loss_max_rel_err"] <= 1e-5
        assert all(b < line["param_bytes_one_device"] for b in line["param_bytes_per_rank"])
    assert out["2x1"]["checkpoint_restored_on_one_device_bit_exact"] is True
