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
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


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
                "launch/serve.py", "kernels/paged_attention.py", "kernels/rwma_gemm.py"):
        assert mod in names, mod


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
