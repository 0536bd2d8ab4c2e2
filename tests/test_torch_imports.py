"""Import hygiene of the PyTorch port, and its entry points' device rule."""
import pytest

torch = pytest.importorskip("torch")

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "mla_probe.py"]
            + sorted((REPO / "examples").glob("torch_*.py")))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_tiny_encoder_runs_without_jax_loaded():
    code = """
import sys
import torch
from repro_torch.core import encoder as enc
cfg = enc.EncoderConfig(seq_len=24, d_model=32, n_heads=2, d_head=16, d_ff=48,
                        n_layers=1, block=8)
bp = enc.block_params(enc.init_params(cfg, device="cpu"), cfg, device="cpu")
y = enc.encoder_bwma(bp, torch.randn(24, 32, generator=torch.Generator().manual_seed(0)), cfg)
assert y.shape == (24, 32) and torch.isfinite(y).all()
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not loaded, loaded
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_entry_points_default_to_the_card():
    from repro_torch.core import encoder as enc

    cfg = enc.EncoderConfig(seq_len=16, d_model=16, n_heads=1, d_head=16, d_ff=16,
                            n_layers=1, block=8)
    if torch.cuda.is_available():
        assert enc.init_params(cfg)[0]["wq"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        enc.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        enc.params_from_numpy([{"w": [1.0]}])
    p = enc.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        enc.block_params(p, cfg)


def test_port_files_include_the_serving_slice():
    names = {str(p.relative_to(PORT)) for p in _port_files() if PORT in p.parents}
    for mod in ("configs/base.py", "models/model.py", "models/adapters.py",
                "serve/engine.py", "serve/kvcache.py", "serve/obs.py", "serve/scheduler.py",
                "launch/serve.py", "kernels/paged_attention.py", "kernels/rwma_gemm.py",
                "kernels/bwma_softmax.py", "kernels/bwma_transpose.py"):
        assert mod in names, mod


def test_port_files_include_the_training_slice():
    names = {str(p.relative_to(PORT)) for p in _port_files() if PORT in p.parents}
    for mod in ("tree.py", "optim/adamw.py", "optim/schedules.py", "data/pipeline.py",
                "train/compression.py", "train/loop.py", "checkpoint/manager.py",
                "launch/steps.py", "launch/train.py"):
        assert mod in names, mod


def test_port_files_include_the_tensor_parallel_slice():
    names = {str(p.relative_to(PORT)) for p in _port_files() if PORT in p.parents}
    for mod in ("distributed/__init__.py", "distributed/axes.py", "distributed/sharding.py",
                "launch/mesh.py"):
        assert mod in names, mod


@pytest.mark.parametrize("helper", ["torch_mesh_ranks.py", "torch_mesh_train_ranks.py"])
def test_mesh_rank_helpers_import_no_jax_and_no_repro(helper):
    """The processes a mesh test starts run the port alone."""
    bad = _imported_roots(REPO / "tests" / helper) & set(FORBIDDEN)
    assert not bad, f"tests/{helper} imports {sorted(bad)}"


def test_port_files_include_the_training_mesh():
    """The training mesh's parts live in the port's modules."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import make_batch_sharded
    from repro_torch.distributed import axes, sharding
    from repro_torch.launch import mesh
    from repro_torch.train.compression import compressed_psum

    assert callable(make_batch_sharded) and callable(compressed_psum)
    for name in ("enter", "psum", "gather_slices", "data_sum", "materialize",
                 "make_train_policy"):
        assert callable(getattr(axes, name)), name
    for name in ("train_placement", "TrainLayout", "Sharding", "gather_full",
                 "whole_leaves"):
        assert hasattr(sharding, name), name
    assert callable(mesh.make_mesh)
    assert "shardings" in CheckpointManager.restore.__code__.co_varnames


@pytest.mark.parametrize("sub", ["optim", "train", "data", "checkpoint", "distributed"])
def test_training_subpackages_import_no_jax_or_ml_dtypes(sub):
    for path in sorted((PORT / sub).rglob("*.py")):
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_training_entry_points_default_to_the_card(tmp_path):
    import repro_torch.configs as C
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import Trainer, TrainerConfig

    cfg = C.get_config("minicpm-2b", smoke=True, dtype=torch.float32)
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.ones(2)}, blocking=True)
    if torch.cuda.is_available():
        assert Trainer(cfg).device.type == "cuda"
        assert m.restore({"w": torch.ones(2)})[1]["w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, None, TrainerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        m.restore({"w": torch.ones(2)})
    assert m.restore({"w": torch.ones(2)}, device="cpu")[1]["w"].device.type == "cpu"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "minicpm-2b", "--smoke", "--steps", "1"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_serving_entry_points_default_to_the_card():
    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server

    cfg = C.get_config("minicpm-2b", smoke=True, dtype=torch.float32)
    if torch.cuda.is_available():
        assert M.init_params(cfg)["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.params_from_numpy({"embed": [[1.0]]})
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(cfg, params, ServeConfig())
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "minicpm-2b", "--smoke"], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_chip_smoke_fails_alone_and_without_a_card(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
