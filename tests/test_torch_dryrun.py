"""The port's dry run against the JAX package's: the cell specs, the skip
rule, the production meshes over a fake group, the per-device argument
bytes of full-configuration cells against those the JAX specs imply, and
the runtime of the multi-pod meshes (three axes) on gloo ranks against one
device.

The production meshes need a default process group of 256 or 512 ranks;
the cases that build them run in a child process (``fake`` backend), so no
group outlives them in this one.
"""
import functools
import json
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import repro.configs as JC
import repro_torch.configs as C
from repro.configs import shapes as JS
from repro.distributed import sharding as JSH
from repro.distributed.axes import abstract_mesh
from repro.models import model as JM
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import shapes as S

REPO = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
# full-configuration cells whose rank-0 argument bytes are held against the
# JAX specs (built, not traced: the trace of a train cell takes minutes)
BYTE_CELLS = [
    ("starcoder2-7b", "train_4k", "single"),
    ("starcoder2-7b", "decode_32k", "single"),
    ("starcoder2-7b", "train_4k", "multi"),
    ("deepseek-v3-671b", "decode_32k", "multi"),
    ("hymba-1.5b", "long_500k", "multi"),
    ("whisper-tiny", "prefill_32k", "single"),
]
# cells traced whole (cheap ones)
TRACED_CELLS = [
    ("mamba2-130m", "decode_32k", "single"),
    ("whisper-tiny", "decode_32k", "multi"),
    ("h2o-danube-3-4b", "long_500k", "single"),
]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")


def _ways(spec, sizes):
    return math.prod(sizes[a] for e in spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,)))


def _share(tree, specs, sizes):
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize // _ways(sp, sizes)
               for x, sp in zip(leaves, spec_leaves))


def _jax_argument_bytes(arch, shape_name, mesh_name):
    """Rank 0's argument bytes as the JAX dry run places the cell: the
    parameters, moments, batch and caches, each leaf's share under its
    spec."""
    cfg = JC.get_config(arch)
    sizes, names = MESHES[mesh_name]
    mesh = abstract_mesh(sizes, names)
    ways = dict(zip(names, sizes))
    spec = JS.input_specs(cfg, shape_name)
    params = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    if spec["kind"] == "decode":
        total = _share(params, JSH.param_pspecs(cfg, mesh, params, mode="serve"), ways)
        total += _share(spec["caches"], JSH.cache_pspecs(cfg, mesh, spec["caches"]), ways)
        tok = {"tokens": spec["tokens"]}
        return total + _share(tok, JSH.batch_pspecs(cfg, mesh, tok), ways)
    pspecs = JSH.param_pspecs(cfg, mesh, params, mode="train")
    total = _share(params, pspecs, ways)
    total += _share(spec["batch"], JSH.batch_pspecs(cfg, mesh, spec["batch"]), ways)
    if spec["kind"] == "train":
        oc = JOptConfig(moment_dtype=jnp.bfloat16 if cfg.param_count() > 1e11
                        else jnp.float32)
        opt = jax.eval_shape(lambda p: j_adamw_init(p, oc), params)
        total += _share(opt, JSH.opt_pspecs(cfg, mesh, opt, pspecs), ways)
    return total


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    """The fake-group cases, run once in a child process: both production
    meshes' shapes and coordinates, each byte cell's rank-0 argument bytes
    (built, not traced) and each traced cell's record."""
    out = tmp_path_factory.mktemp("dryrun") / "out.json"
    code = f"""
import json, sys
import repro_torch.configs as C
from repro_torch.analysis.aot import argument_bytes
from repro_torch.launch import dryrun as D
res = {{"meshes": {{}}, "bytes": {{}}, "records": []}}
for kind in ("single", "multi"):
    mesh = D.production_mesh(kind)
    res["meshes"][kind] = [list(mesh.shape), list(mesh.mesh_dim_names),
                           list(mesh.get_coordinate())]
    for arch, shape, m in {BYTE_CELLS!r}:
        if m == kind:
            _fn, args, info = D.build_cell(C.get_config(arch), shape, mesh)
            res["bytes"]["/".join((arch, shape, m))] = [argument_bytes(args), info["accum"]]
    for arch, shape, m in {TRACED_CELLS!r}:
        if m == kind:
            res["records"].append(D.run_cell(arch, shape, m, None))
res["records"].append(D.run_cell("qwen1.5-110b", "long_500k", "multi", None))
json.dump(res, open({str(out)!r}, "w"))
"""
    r = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", JC.arch_ids())
def test_cell_specs_match_jax(arch):
    """applicable, input_specs and cache_specs: the JAX shapes and dtypes,
    and the JAX skip message, for every shape."""
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k in tree:
                yield from flat(tree[k], path + (k,))
        elif not isinstance(tree, str):
            yield path, tree

    for shape in JC.SHAPES:
        assert S.applicable(cfg, shape) == JS.applicable(jcfg, shape)
        if not S.applicable(cfg, shape)[0]:
            continue
        want = {p: (tuple(x.shape), np.dtype(x.dtype).name)
                for p, x in flat(JS.input_specs(jcfg, shape))}
        got = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
               for p, x in flat(S.input_specs(cfg, shape))}
        assert got == want, shape
        assert all(x.device.type == "meta" for _p, x in flat(S.input_specs(cfg, shape)))


def test_applicable_refuses_an_unknown_shape():
    with pytest.raises(KeyError):
        S.applicable(C.get_config("mamba2-130m"), "train_8k")


def test_production_meshes_over_a_fake_group(child):
    assert child["meshes"]["single"] == [[16, 16], ["data", "model"], [0, 0]]
    assert child["meshes"]["multi"] == [[2, 16, 16], ["pod", "data", "model"], [0, 0, 0]]


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch import mesh as LM

    with pytest.raises(RuntimeError, match="no process group"):
        LM.make_production_mesh()


@pytest.mark.parametrize("cell", BYTE_CELLS, ids=lambda c: "/".join(c))
def test_argument_bytes_match_the_jax_specs(child, cell):
    got, _accum = child["bytes"]["/".join(cell)]
    assert got == _jax_argument_bytes(*cell)


def test_accum_steps_follow_pick_accum_steps(child):
    """starcoder2-7b train_4k: 16 rows a data rank on the single pod (8
    microbatches at the 4 GiB budget), 8 on the multi-pod mesh."""
    assert child["bytes"]["starcoder2-7b/train_4k/single"][1] == 8
    assert child["bytes"]["starcoder2-7b/train_4k/multi"][1] == 4


def test_traced_cells(child):
    recs = {(r["arch"], r["shape"], r["mesh"]): r for r in child["records"]}
    for cell in TRACED_CELLS:
        rec = recs[cell]
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["n_devices"] == {"single": 256, "multi": 512}[cell[2]]
        assert rec["flops"] > 0 and rec["collectives"]["count"] > 0
        assert set(rec["memory"]) == {"temp_size_in_bytes", "argument_size_in_bytes",
                                      "output_size_in_bytes"}
        assert rec["memory"]["argument_size_in_bytes"] == _jax_argument_bytes(*cell)
        assert rec["params"] == JC.get_config(cell[0]).param_count()


def test_skipped_cell_gives_the_jax_message(child):
    recs = {(r["arch"], r["shape"], r["mesh"]): r for r in child["records"]}
    rec = recs[("qwen1.5-110b", "long_500k", "multi")]
    assert rec["status"] == "skipped"
    assert rec["reason"] == JS.applicable(JC.get_config("qwen1.5-110b"), "long_500k")[1]


@functools.lru_cache(maxsize=None)
def _one_device_cell(arch, shape):
    from repro_torch.analysis.aot import trace_step
    from repro_torch.launch import dryrun as D

    fn, args, _info = D.build_cell(C.get_config(arch), shape, None)
    return trace_step(fn, args), args


def test_one_device_decode_cell_on_meta():
    """mamba2-130m decode_32k on one device (chip_smoke.py's phase 19 on
    meta): no collective, the arguments the whole parameters, caches and
    tokens, the FLOPs above the head's matmul alone, the logits' shape."""
    art, _args = _one_device_cell("mamba2-130m", "decode_32k")
    cfg = C.get_config("mamba2-130m")
    assert art.collectives["count"] == 0
    assert art.memory["argument_size_in_bytes"] == _jax_argument_bytes(
        "mamba2-130m", "decode_32k", "1x1")
    assert art.flops > 2 * 128 * cfg.d_model * cfg.padded_vocab
    assert tuple(art.outputs[0].shape) == (128, 1, cfg.padded_vocab)
    assert art.outputs[0].device.type == "meta"


def test_mesh_runtime_against_one_device(tmp_path):
    """Four gloo ranks on ``2 x 2`` and on ``2 x 1 x 2`` (``("pod", "data",
    "model")``; tests/torch_dryrun_ranks.py): the dry run's decode (the
    exact JAX serve shares, split caches) for every family, one-row
    decodes, three Trainer steps (ZeRO over the data axes, MoE) and a
    prefill on the trainer's placement, each against one device."""
    script = REPO / "tests" / "torch_dryrun_ranks.py"
    runs = {}
    for shape in ("2x2", "2x1x2"):
        d = tmp_path / shape
        d.mkdir()
        procs = [subprocess.Popen([sys.executable, str(script), str(d / "store"), str(r), "4",
                                   shape, str(d)], env=_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(4)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
        runs[shape] = [pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(4)]
    for shape, ranks in runs.items():
        for r, res in enumerate(ranks):
            for key, v in res.items():
                assert "error" not in v, (shape, r, key, v.get("error"))
                if key.startswith("decode"):
                    assert v["logits_err"] <= 1e-5 * max(1.0, v["scale"]), (shape, key, v)
                    assert v["cache_err"] <= 1e-5, (shape, key, v)
                    assert v["stored"] == v["jax_share"], (shape, key)
                elif key.startswith("train"):
                    assert v["split"] and v["loss_err"] <= 1e-5 and v["param_err"] <= 1e-5
                else:
                    assert v["logits_err"] <= 1e-5 * max(1.0, v["scale"]), (shape, key, v)
        one_row = ranks[0]["decode-mamba2-130m-1x32"]
        assert not one_row["row_split"]
        assert ranks[0]["decode-h2o-danube-3-4b-1x32"]["seq"] == (0, 4)
        assert ranks[0]["decode-starcoder2-7b-4x16"]["seq"] == (0, 2)


def test_dryrun_cli_writes_records(tmp_path):
    out = tmp_path / "recs"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "whisper-tiny", "--shape", "decode_32k", "long_500k", "--mesh",
                        "single", "--out", str(out)], env=_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "done: 1 ok, 0 errors, 1 skipped" in r.stdout
    rec = json.loads((out / "whisper-tiny_decode_32k_single.json").read_text())
    assert rec["status"] == "ok" and rec["accum_steps"] == 1 and rec["n_devices"] == 256


def test_chip_smoke_dryrun_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 19 on the CPU with mamba2-130m's smoke config
    (SSD chunks of 128): each cell traced on meta, its rows cut by the
    prediction to a 64 MB budget, then run for real; argument bytes and
    FLOPs equal, no collective."""
    import dataclasses

    import torch

    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke as cs

    cfg = dataclasses.replace(C.get_config("mamba2-130m", smoke=True), ssm_chunk=128)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = cs.dryrun_phase(torch, device="cpu", cfg=cfg, budget=64 * 2**20)
    finally:
        torch.set_num_threads(n)
    assert set(out) == {"decode_32k", "prefill_32k"}
    for row in out.values():
        assert row["argument_bytes"] == row["real_argument_bytes"]
        assert row["flops"] == row["real_flops"] > 0 and row["collectives"] == 0
    assert out["prefill_32k"]["rows"] < out["prefill_32k"]["rows_of_cell"] == 32
    assert out["prefill_32k"]["full_cell_predicted_peak_bytes"] > 64 * 2**20


def test_kernel_wrappers_give_shapes_on_meta():
    """Given meta tensors, a kernel wrapper runs its plain version's shapes
    (``_build.on_cuda`` answers False, as for the CPU) and computes
    nothing; a mix of meta and CPU tensors still raises."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.bwma_gemm import bwma_gemm
    from repro_torch.kernels.bwma_softmax import bwma_softmax
    from repro_torch.kernels.paged_attention import paged_attention_decode

    meta = torch.device("meta")
    reset_launch_counts()
    out = bwma_gemm(torch.empty(4, 6, 16, 16, device=meta), torch.empty(6, 3, 16, 16, device=meta))
    assert out.device == meta and tuple(out.shape) == (4, 3, 16, 16)
    sm = bwma_softmax(torch.empty(2, 4, 4, 16, 16, device=meta), n_logical=60)
    assert sm.device == meta and tuple(sm.shape) == (2, 4, 4, 16, 16)
    o = paged_attention_decode(torch.empty(2, 1, 8, 64, device=meta),
                               torch.empty(5, 16, 2, 64, device=meta),
                               torch.empty(5, 16, 2, 64, device=meta),
                               torch.zeros(2, 3, dtype=torch.int32, device=meta),
                               torch.zeros(2, dtype=torch.int32, device=meta))
    assert o.device == meta and tuple(o.shape) == (2, 1, 8, 64)
    assert not any(launch_counts().values())
    with pytest.raises(ValueError, match="operands must all be on one CUDA device"):
        bwma_gemm(torch.empty(4, 6, 16, 16, device=meta), torch.empty(6, 3, 16, 16))
