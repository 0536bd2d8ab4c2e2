"""The port's training system on the CPU: the twins of
``tests/test_system.py`` (training loop, checkpoint/restart, straggler
watchdog, int8 gradient compression, microbatching, data determinism, the
WSD shape) and its parity with the JAX package: synthetic batches bit-equal
to the JAX package's, fp32 checkpoints that restore across the two packages
bit for bit, and a 3-step ``Trainer.fit`` loss history within 1e-5 of the
JAX ``Trainer``'s from the same initial state.
"""
import dataclasses
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
import repro.optim as JO
import repro_torch.configs as TC
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.data import TokenFileData as JTokenFileData
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train.compression import dequantize_leaf as jdequantize
from repro.train.compression import quantize_leaf as jquantize
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMData, TokenFileData
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_init, wsd_schedule
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.compression import dequantize_leaf, quantize_leaf

REPO = Path(__file__).resolve().parents[1]
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
            vocab_size=256)


def _tiny_cfg():
    return TC.get_config("minicpm-2b", smoke=True, dtype=torch.float32, **TINY)


def _jax_tiny_cfg():
    return JC.get_config("minicpm-2b", smoke=True, dtype=jnp.float32, **TINY)


def _trainer(tc, oc=None, **kw):
    return Trainer(_tiny_cfg(), None, tc, oc, device="cpu", **kw)


def _equal_trees(a, b):
    la, lb = T.leaves(a), T.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --------------------------------------------------------------------------
# the twins of tests/test_system.py
# --------------------------------------------------------------------------

def test_training_reduces_loss():
    tc = TrainerConfig(steps=30, checkpoint_every=0, log_every=10)
    data = SyntheticLMData(_tiny_cfg(), global_batch=8, seq_len=32)
    _, _, hist = _trainer(tc, OptConfig(lr=3e-3)).fit(data)
    assert [h["step"] for h in hist] == [0, 10, 20]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3


def test_checkpoint_restart_bitexact(tmp_path):
    """Kill after 5 steps, restart: the final state equals the
    uninterrupted run's bit for bit (deterministic data, restored state,
    and CPU arithmetic)."""
    data = SyntheticLMData(_tiny_cfg(), global_batch=8, seq_len=32)
    tc_a = TrainerConfig(steps=10, checkpoint_every=0, log_every=100)
    params_a, opt_a, _ = _trainer(tc_a, OptConfig(lr=1e-3)).fit(data)
    d = str(tmp_path / "ckpt")
    tc_b = TrainerConfig(steps=5, checkpoint_every=0, log_every=100, checkpoint_dir=d)
    _trainer(tc_b, OptConfig(lr=1e-3)).fit(data)  # saves the final state at step 5
    tc_c = TrainerConfig(steps=10, checkpoint_every=0, log_every=100, checkpoint_dir=d)
    tr_c = _trainer(tc_c, OptConfig(lr=1e-3))
    step0, _, _ = tr_c.restore_or_init()
    assert step0 == 5
    params_c, opt_c, _ = tr_c.fit(data)
    _equal_trees((params_a, opt_a), (params_c, opt_c))


def test_checkpoint_atomicity_and_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last_k=2)
    tree = {"a": torch.ones((4, 4)), "b": {"c": torch.zeros((2,))}}
    for s in (1, 2, 3, 4):
        m.save(s, tree, blocking=True)
    assert m.available_steps() == [3, 4]  # gc keeps the last 2
    os.makedirs(tmp_path / "step_00000009.tmp")  # a save that crashed mid-write
    assert m.latest_step() == 4
    step, restored = m.restore(tree, device="cpu")
    assert step == 4
    _equal_trees(restored, tree)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree, device="cpu")


def test_checkpoint_async_save_and_its_error(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(6.0)}
    m.save(1, tree)  # in the background
    tree["w"].add_(100.0)  # the host copy was taken at save()
    m.wait()
    np.testing.assert_array_equal(m.restore(tree, device="cpu")[1]["w"].numpy(),
                                  np.arange(6.0, dtype=np.float32))
    (tmp_path / "step_00000002.tmp").write_text("a file where the writer needs a directory")
    m.save(2, tree)
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        m.wait()
    m.wait()  # raised once


def test_straggler_watchdog_records():
    tc = TrainerConfig(steps=3, checkpoint_every=0, log_every=100, step_deadline_s=1e-9)
    tr = _trainer(tc)
    tr.fit(SyntheticLMData(_tiny_cfg(), global_batch=8, seq_len=32))
    assert [e["step"] for e in tr.straggler_events] == [0, 1, 2]


def test_grad_compression_int8_roundtrip_matches_jax():
    g = np.random.default_rng(0).standard_normal((128, 64)).astype(np.float32) * 0.01
    q, scale = quantize_leaf(torch.from_numpy(g))
    jq, jscale = jquantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    back = dequantize_leaf(q, scale, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jdequantize(jq, jscale,
                                                                        jnp.float32)))
    # the largest quantization error is scale/2 (+ rounding slack)
    assert float((back - torch.from_numpy(g)).abs().max()) <= float(scale) * 0.51


def test_grad_compression_trainer_still_learns():
    tc = TrainerConfig(steps=20, checkpoint_every=0, log_every=10, grad_compression="int8")
    _, _, hist = _trainer(tc, OptConfig(lr=3e-3)).fit(
        SyntheticLMData(_tiny_cfg(), global_batch=8, seq_len=32))
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_microbatch_accumulation_matches_full_batch():
    cfg = _tiny_cfg()
    oc = OptConfig(lr=1e-3)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params, oc)
    batch = SyntheticLMData(cfg, global_batch=8, seq_len=32).batch(0)

    def lr(s):
        return 1e-3

    p1, _, m1 = steps.make_train_step(cfg, oc, lr, accum_steps=1)(params, opt, batch)
    p4, _, m4 = steps.make_train_step(cfg, oc, lr, accum_steps=4)(params, opt, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=2e-3)
    for a, b in zip(T.leaves(p1), T.leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4)


def test_trainer_accumulation_matches_one_batch():
    data = SyntheticLMData(_tiny_cfg(), global_batch=8, seq_len=32)
    out = [_trainer(TrainerConfig(steps=2, checkpoint_every=0, log_every=1,
                                  accum_steps=a), OptConfig(lr=1e-3)).fit(data)
           for a in (1, 2)]
    for h1, h2 in zip(out[0][2], out[1][2]):
        np.testing.assert_allclose(h1["loss"], h2["loss"], rtol=2e-3)
    for a, b in zip(T.leaves(out[0][0]), T.leaves(out[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4)


def test_split_microbatches_matches_jax():
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (8, 6)).astype(np.int32),
             "positions3": rng.integers(0, 9, (3, 8, 6)).astype(np.int32),
             "vis_embeds": rng.standard_normal((8, 2, 4)).astype(np.float32)}
    want = jsteps.split_microbatches({k: jnp.asarray(v) for k, v in batch.items()}, 4)
    got = steps.split_microbatches({k: torch.from_numpy(v) for k, v in batch.items()}, 4)
    assert got["positions3"].shape == (4, 3, 2, 6)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v3-671b", "qwen2-vl-72b"])
def test_pick_accum_steps_matches_jax(arch):
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    for gb, seq, dp in ((256, 4096, 8), (32, 2048, 1), (4, 512, 1)):
        assert steps.pick_accum_steps(tc, gb, seq, dp) == jsteps.pick_accum_steps(
            jc, gb, seq, dp)


def test_data_pipeline_deterministic_and_restart_consistent():
    cfg = _tiny_cfg()
    b1 = SyntheticLMData(cfg, global_batch=4, seq_len=16, seed=3).batch(5)
    b2 = SyntheticLMData(cfg, global_batch=4, seq_len=16, seed=3).batch(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert int(b1["tokens"].max()) < cfg.vocab_size
    it = iter(SyntheticLMData(cfg, global_batch=4, seq_len=16, seed=3))
    for _ in range(6):
        b = next(it)
    assert torch.equal(b["tokens"], b1["tokens"])  # step 5 again


def test_wsd_schedule_shape():
    lr = wsd_schedule(1.0, warmup=10, stable=20, decay=10)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(25)) == pytest.approx(1.0)
    assert float(lr(40)) < 0.05


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [("minicpm-2b", "float32"), ("qwen2-vl-72b", "float32"),
                                        ("qwen2-vl-72b", "bfloat16"),
                                        ("whisper-tiny", "bfloat16")])
def test_synthetic_batches_bit_equal_to_jax(arch, dtype):
    jc = JC.get_config(arch, smoke=True, dtype=getattr(jnp, dtype))
    tc = TC.get_config(arch, smoke=True, dtype=getattr(torch, dtype))
    for step in (0, 7):
        want = JSyntheticLMData(jc, global_batch=3, seq_len=12, seed=2).batch(step)
        got = SyntheticLMData(tc, global_batch=3, seq_len=12, seed=2).batch(step)
        assert set(got) == set(want)
        for k, v in want.items():
            g = got[k]
            if g.dtype == torch.bfloat16:  # compare the 16-bit patterns
                g, v = g.view(torch.int16), np.asarray(v).view(np.int16)
            np.testing.assert_array_equal(g.numpy(), np.asarray(v), err_msg=k)


def test_token_file_data_matches_jax(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 500).astype(np.int32).tofile(path)
    want = JTokenFileData(str(path), global_batch=4, seq_len=16, seed=1).batch(3)
    got = TokenFileData(str(path), global_batch=4, seq_len=16, seed=1).batch(3)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="too small"):
        TokenFileData(str(path), global_batch=1, seq_len=600)


def _jax_state():
    jc = _jax_tiny_cfg()
    params = JM.init_params(jc, jax.random.PRNGKey(0))
    opt = JO.adamw_init(params)
    opt = dict(opt, m=jax.tree.map(lambda x: x + 0.5, opt["m"]), step=jnp.int32(7))
    return params, opt


def test_fp32_checkpoints_cross_between_packages(tmp_path):
    """JAX writes, the port restores bit for bit; the port writes, JAX
    restores bit for bit (leaves in the JAX package's flatten order)."""
    jtree = _jax_state()
    JCheckpointManager(str(tmp_path / "j"), keep_last_k=1).save(3, jtree, blocking=True)
    like = T.tree_map(lambda x: torch.from_numpy(np.array(x)), jtree)
    step, got = CheckpointManager(str(tmp_path / "j")).restore(like, device="cpu")
    assert step == 3 and got[1]["step"].dtype == torch.int32 and int(got[1]["step"]) == 7
    for g, w in zip(T.leaves(got), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    CheckpointManager(str(tmp_path / "t")).save(4, got, blocking=True)
    step, back = JCheckpointManager(str(tmp_path / "t")).restore(jtree)
    assert step == 4
    for b, w in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert b.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(b), np.asarray(w))


def test_bf16_checkpoint_keeps_bit_patterns(tmp_path):
    cfg = dataclasses.replace(_tiny_cfg(), dtype=torch.bfloat16)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    state = (params, adamw_init(params))
    m = CheckpointManager(str(tmp_path))
    m.save(2, state, blocking=True)
    import json
    meta = json.loads((tmp_path / "step_00000002" / "META.json").read_text())
    assert "bfloat16" in meta["dtypes"] and meta["paths"][0].startswith("[0]")
    _equal_trees(m.restore(state, device="cpu")[1], state)


def test_trainer_history_matches_jax_trainer(tmp_path):
    """3 steps of the port's Trainer against the JAX Trainer on
    make_local_mesh(), from the same initial state (the JAX Trainer's own,
    handed over through a JAX checkpoint at step 0): every logged loss
    within 1e-5 relative."""
    jc = _jax_tiny_cfg()
    jtc = JTrainerConfig(steps=3, checkpoint_every=0, log_every=1)
    jtr = JTrainer(jc, make_local_mesh(), jtc, JO.OptConfig(lr=3e-3))
    d = str(tmp_path / "ckpt")
    JCheckpointManager(d).save(0, jtr.init_state(), blocking=True)
    jparams, _, want = jtr.fit(JSyntheticLMData(jc, global_batch=8, seq_len=32))
    tc = TrainerConfig(steps=3, checkpoint_every=0, log_every=1, checkpoint_dir=d)
    params, _, got = _trainer(tc, OptConfig(lr=3e-3)).fit(
        SyntheticLMData(_tiny_cfg(), global_batch=8, seq_len=32))
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (g, w)
    for a, b in zip(T.leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_mesh_is_refused():
    """The refusals that remain: a non-mesh or an abstract mesh is no mesh
    of ranks to train on (``TypeError``), and the CLI's production meshes
    name the dry run's item (``make_production_mesh``, item 27).  A
    ``DeviceMesh`` trains (``tests/test_torch_mesh_train.py``)."""
    from repro_torch.distributed.axes import abstract_mesh

    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(_tiny_cfg(), object(), TrainerConfig(), device="cpu")
    with pytest.raises(TypeError, match="abstract mesh"):
        Trainer(_tiny_cfg(), abstract_mesh((2, 1), ("data", "model")), TrainerConfig(),
                device="cpu")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "minicpm-2b", "--smoke", "--device", "cpu", "--steps", "1",
                        "--mesh", "single"], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "item 27" in r.stderr


def test_train_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "minicpm-2b",
            "--smoke", "--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16"]
    ckpt = tmp_path / "ckpt"
    r = subprocess.run(base + ["--wsd", "--ckpt", str(ckpt), "--ckpt-every", "2"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "final loss" in r.stdout and "on cpu" in r.stdout
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000004"]
