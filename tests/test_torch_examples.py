"""The four examples of the PyTorch port run on the CPU at their small
settings (``--device cpu``), each in its own process, with neither ``jax``
nor ``repro`` loaded."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

CASES = {
    "torch_quickstart": ([], ("max |BWMA - RWMA|", "bwma_gemm on cpu", "x speedup")),
    "torch_bwma_layer_comparison": (["--fast"], ("Fig. 6a", "Fig. 6b", "Fig. 7", "Fig. 8",
                                                 "conversion")),
    "torch_train_lm": (["--tiny", "--steps", "12"], ("loss:", "last checkpoint: step 12")),
    "torch_serve_batched": ([], ("hymba-1.5b", "continuous batching", "decode steps")),
}

# run the example as a script, then refuse any JAX-side module it loaded
_RUNNER = """
import runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
"""


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name):
    args, expect = CASES[name]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _RUNNER, str(REPO / "examples" / f"{name}.py"),
                        "--device", "cpu", *args], env=env, capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    for text in expect:
        assert text in r.stdout, (text, r.stdout[-2000:])


def test_examples_default_to_the_card():
    import ast

    for name in CASES:
        tree = ast.parse((REPO / "examples" / f"{name}.py").read_text())
        defaults = [kw.value.value for node in ast.walk(tree) if isinstance(node, ast.Call)
                    for kw in node.keywords
                    if kw.arg == "default" and isinstance(kw.value, ast.Constant)
                    and node.args and getattr(node.args[0], "value", None) == "--device"]
        assert defaults == ["cuda"], name
