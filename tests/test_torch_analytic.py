"""The port's analytic roofline against the JAX package's: the same FLOPs and
bytes, the H100's constants in place of the TPU's, the JAX file's
invariants, and the roofline report over the port's own dry-run records."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.configs as JC
import repro_torch.configs as C
from repro.analysis import analytic as JA
from repro_torch.analysis import analytic as A
from repro_torch.analysis import roofline as R
from repro_torch.distributed import sharding as SH

REPO = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESHES = ("single", "multi")


@pytest.mark.parametrize("arch", JC.arch_ids())
def test_flops_and_bytes_equal_jax(arch):
    """Every shape x mesh x accum: the four byte and FLOP functions are the
    JAX ones exactly; the time terms are those values over the H100's
    constants."""
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)
    for shape in SHAPES:
        f = A.step_flops_global(cfg, shape)
        assert f == JA.step_flops_global(jcfg, shape)
        assert A.cache_bytes_global(cfg, shape) == JA.cache_bytes_global(jcfg, shape)
        for mesh in MESHES:
            jm, m = getattr(JA.MeshInfo, mesh)(), getattr(A.MeshInfo, mesh)()
            assert (m.n_dev, m.dp, m.tp) == (jm.n_dev, jm.dp, jm.tp)
            for accum in (1, 2, 4, 8):
                hbm = A.hbm_bytes_per_device(cfg, shape, m, accum)
                coll = A.collective_bytes_per_device(cfg, shape, m, accum)
                assert hbm == JA.hbm_bytes_per_device(jcfg, shape, jm, accum)
                assert coll == JA.collective_bytes_per_device(jcfg, shape, jm, accum)
                t = A.roofline_terms(cfg, shape, m, accum)
                assert t["compute"] == f / (m.n_dev * 989e12)
                assert t["memory"] == hbm / 3.35e12
                assert t["collective"] == coll / 50e9
                assert t["flops_global"] == f


def test_constants_are_the_h100s():
    assert (A.PEAK_FLOPS, A.HBM_BW, A.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert R.HBM_BYTES == 80e9
    src = (REPO / "src/repro_torch/analysis/analytic.py").read_text()
    for tpu in ("197e12", "819e9", "v5e", "ICI"):
        assert tpu not in src
    assert src.count("spec") >= 3


def test_replicate_below_is_the_sharding_rules():
    assert A.REPLICATE_BELOW == SH.REPLICATE_BELOW == JA.REPLICATE_BELOW


# ---- the JAX file's invariants (tests/test_analytic.py), mirrored ----

@pytest.mark.parametrize("arch", C.arch_ids())
@pytest.mark.parametrize("shape", SHAPES)
def test_terms_positive_and_finite(arch, shape):
    t = A.roofline_terms(C.get_config(arch), shape, A.MeshInfo.single(), accum=2)
    for k in ("compute", "memory", "collective"):
        assert 0 <= t[k] < 1e5, (arch, shape, k, t[k])
    assert 0 <= t["roofline_fraction"] <= 1.0 + 1e-9
    assert t["roofline_fraction_serial"] <= t["roofline_fraction"] + 1e-9


def test_train_flops_close_to_6nd():
    for arch in ("qwen1.5-110b", "minicpm-2b", "starcoder2-7b"):
        cfg = C.get_config(arch)
        f = A.step_flops_global(cfg, "train_4k")
        six_nd = 6 * cfg.active_param_count() * 4096 * 256
        assert 0.8 * six_nd < f < 2.5 * six_nd, (arch, f / six_nd)


def test_moe_flops_use_active_params():
    ds = C.get_config("deepseek-v3-671b")
    assert A.step_flops_global(ds, "train_4k") < 0.25 * 6 * ds.param_count() * 4096 * 256


def test_cache_bytes_family_ordering():
    mamba = A.cache_bytes_global(C.get_config("mamba2-130m"), "decode_32k")
    danube = A.cache_bytes_global(C.get_config("h2o-danube-3-4b"), "decode_32k")
    qwen = A.cache_bytes_global(C.get_config("qwen1.5-110b"), "decode_32k")
    mla = A.cache_bytes_global(C.get_config("deepseek-v3-671b"), "decode_32k")
    assert mamba < danube < qwen
    assert mla / 61 < qwen / 80


def test_decode_memory_includes_cache():
    t32 = A.roofline_terms(C.get_config("qwen1.5-110b"), "decode_32k", A.MeshInfo.single())
    assert t32["memory"] > 0
    assert t32["dominant"] in ("memory", "collective")


def test_accum_halving_halves_train_collective_term():
    cfg = C.get_config("deepseek-v3-671b")
    t8 = A.roofline_terms(cfg, "train_4k", A.MeshInfo.multi(), accum=8)
    t4 = A.roofline_terms(cfg, "train_4k", A.MeshInfo.multi(), accum=4)
    assert t4["collective"] < 0.62 * t8["collective"]
    assert t4["roofline_fraction"] > 1.5 * t8["roofline_fraction"]


# ---- the report over the port's dry-run records ----

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """mamba2-130m's and whisper-tiny's decode_32k and long_500k cells on
    both meshes (whisper's long_500k a skip) from the dry-run CLI, then the
    roofline CLI over them."""
    d = tmp_path_factory.mktemp("roofline")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "mamba2-130m", "whisper-tiny", "--shape", "decode_32k", "long_500k",
                        "--mesh", "single", "multi", "--out", str(d / "rec")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.roofline", "--dryrun",
                        str(d / "rec"), "--out", str(d / "roofline.md")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return R.load_all(str(d / "rec")), (d / "roofline.md").read_text(), r.stdout


def test_analyze_record_reads_the_dry_run(records):
    recs, _md, _out = records
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) == 6 and len(recs) == 8
    for rec in ok:
        row = R.analyze_record(rec)
        cfg = C.get_config(rec["arch"])
        mesh = A.MeshInfo.multi() if rec["mesh"] == "multi" else A.MeshInfo.single()
        assert row["gpus"] == mesh.n_dev == rec["n_devices"]
        assert row["t_compute_s"] == A.roofline_terms(cfg, rec["shape"], mesh)["compute"]
        assert row["flops_dev"] == rec["flops"] > 0
        assert row["allreduce_count"] == rec["collectives"]["count"] > 0
        assert row["useful_ratio"] == R.model_flops(rec) / (rec["flops"] * rec["n_devices"])
        assert row["fits_hbm"]
    assert all(R.analyze_record(r) is None for r in recs if r["status"] != "ok")


def test_markdown_report(records):
    recs, md, out = records
    rows = [R.analyze_record(r) for r in recs if r["status"] == "ok"]
    table = R.markdown_table(rows)
    assert table.count("\n") == len(rows) + 2
    assert "fits 80G" in table and "all-reduces" in table
    assert "989 TF/s" in md and "3.35 TB/s" in md and "6 traced cells, 2 documented skips" in md
    assert "whisper-tiny × long_500k" in md  # the skip, with the JAX message
    assert out.startswith("wrote ") and "6 rows" in out
