"""The port's memory model against the JAX package's numpy model, bit for
bit, on the CPU; and the numpy model's invariants, mirrored.

The full-size BERT-base layer (the JAX file's ``slow`` band) runs on the
card in ``chip_smoke.py``'s phase 18.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import memmodel as J
from repro_torch.core import memmodel as mm

SMALL = mm.WorkloadConfig(seq=128, d_model=192, n_heads=3, d_head=64, d_ff=768)
J_SMALL = J.WorkloadConfig(**dataclasses.asdict(SMALL))
CPU = "cpu"
ACCELS = ("SA8x8", "SA16x16", "SIMD16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the model's sorts are small here, and a loaded
    host's cores make a thread pool wait (30x slower under the suite's
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _accels(name):
    jx = {a.name: a for a in J.PAPER_ACCELERATORS}[name]
    pt = {a.name: a for a in mm.PAPER_ACCELERATORS}[name]
    assert dataclasses.asdict(jx) == dataclasses.asdict(pt)
    return jx, pt


def _np(t):
    return t.numpy()


def test_constants_and_dataclasses_match():
    assert mm.LINE == J.LINE
    assert dataclasses.asdict(mm.CacheConfig()) == dataclasses.asdict(J.CacheConfig())
    assert dataclasses.asdict(SMALL) == dataclasses.asdict(J_SMALL)
    for k in ("CPU_CYC_SOFTMAX", "CPU_CYC_NORM", "CPU_CYC_TRANSPOSE",
              "ADDR_CYCLES_PER_SEGMENT", "GEMM_COMPONENTS", "NON_GEMM_COMPONENTS"):
        assert getattr(mm, k) == getattr(J, k), k
    assert [f.name for f in dataclasses.fields(mm.MemStats)] == \
        [f.name for f in dataclasses.fields(J.MemStats)]


@pytest.mark.parametrize("layout", ["rwma", "bwma"])
@pytest.mark.parametrize("T,es", [(8, 1), (16, 1), (16, 2), (32, 4)])
def test_traces_equal_numpy(layout, T, es):
    tr, meta = mm.gemm_trace(64, 96, 128, T, layout, es, 0, 1 << 22, 2 << 22, device=CPU)
    jt, jmeta = J.gemm_trace(64, 96, 128, T, layout, es, 0, 1 << 22, 2 << 22)
    assert tr.dtype == torch.int64 and np.array_equal(_np(tr), jt) and meta == jmeta
    for passes in (0, 1, 2):
        assert np.array_equal(_np(mm.rowwise_trace(64, 96, T, layout, es, 5 << 22, passes,
                                                   device=CPU)),
                              J.rowwise_trace(64, 96, T, layout, es, 5 << 22, passes))
    assert np.array_equal(_np(mm.transpose_trace(64, 96, T, layout, es, 0, 3 << 22,
                                                 device=CPU)),
                          J.transpose_trace(64, 96, T, layout, es, 0, 3 << 22))


def test_layer_components_equal_numpy():
    for name in ACCELS:
        jx, pt = _accels(name)
        for layout in ("rwma", "bwma"):
            got = mm.bert_layer_components(SMALL, pt, layout, device=CPU)
            want = J.bert_layer_components(J_SMALL, jx, layout)
            assert [n for n, _t, _m in got] == [n for n, _t, _m in want]
            for (_n, t, m), (_jn, jt, jm) in zip(got, want):
                assert np.array_equal(_np(t), jt) and m == jm


def _streams():
    rng = np.random.default_rng(0)
    yield "random", rng.integers(0, 1 << 16, 20_000)
    yield "few sets", rng.integers(0, 64, 5_000) * 512  # all map to one L1 set
    yield "all equal", np.full(3_000, 7)
    yield "sequential", np.arange(10_000)
    yield "strided", np.arange(0, 4_000_000, 4096)
    yield "repeats", np.repeat(rng.integers(0, 1 << 20, 2_000), 3)
    yield "one", np.array([5])
    yield "empty", np.zeros(0, dtype=np.int64)


@pytest.mark.parametrize("name,stream", list(_streams()), ids=[n for n, _ in _streams()])
def test_cache_simulation_equals_numpy(name, stream):
    stream = stream.astype(np.int64)
    t = torch.from_numpy(stream)
    for cache_bytes in (32 * 1024, 1024 * 1024, 64):
        assert np.array_equal(_np(mm._dm_miss(t, cache_bytes)), J._dm_miss(stream, cache_bytes))
    assert np.array_equal(_np(mm._sequential(t)), J._sequential(stream))
    for prefetch in (True, False):
        cache = mm.CacheConfig(prefetch=prefetch)
        got = mm.simulate_trace(t, cache)
        want = J.simulate_trace(stream, J.CacheConfig(prefetch=prefetch))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_interleave_ties_keep_stream_order():
    """Streams of equal (and commensurate) lengths tie exactly on their
    positions i/n: the stable sort keeps concatenation order, as numpy's."""
    rng = np.random.default_rng(1)
    cases = [[rng.integers(0, 1000, n) for n in lens]
             for lens in ((4, 4, 4), (3, 6), (5, 10, 20), (7, 0, 7), (1,), (0, 0), (9, 3, 6, 12))]
    for arrays in cases:
        arrays = [a.astype(np.int64) for a in arrays]
        got = mm._interleave([torch.from_numpy(a) for a in arrays])
        assert np.array_equal(_np(got), J._interleave(arrays))


@pytest.mark.parametrize("name", ACCELS)
def test_simulate_layer_equals_numpy(name):
    """Every MemStats field of every component, both layouts, 1/2/4 cores."""
    jx, pt = _accels(name)
    for layout in ("rwma", "bwma"):
        for cores in (1, 2, 4):
            got = mm.simulate_layer(SMALL, pt, layout, cores, device=CPU)
            want = J.simulate_layer(J_SMALL, jx, layout, cores)
            assert list(got) == list(want)
            for comp in want:
                assert dataclasses.asdict(got[comp]) == dataclasses.asdict(want[comp]), \
                    (name, layout, cores, comp)


def test_speedup_and_conversion_equal_numpy():
    for name in ("SA16x16",):
        jx, pt = _accels(name)
        for cores in (1, 2):
            assert mm.speedup(SMALL, pt, cores, device=CPU) == J.speedup(J_SMALL, jx, cores)
        assert mm.conversion_overhead_fraction(SMALL, pt, device=CPU) == \
            J.conversion_overhead_fraction(J_SMALL, jx)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        mm.simulate_layer(SMALL, mm.AccelSpec.sa(16), "bwma")


# ---- the numpy model's invariants (tests/test_memmodel.py), mirrored ----

def test_gemm_trace_bytes_equal_between_layouts():
    ta, _ = mm.gemm_trace(64, 64, 64, 16, "rwma", 1, 0, 1 << 22, 2 << 22, device=CPU)
    tb, _ = mm.gemm_trace(64, 64, 64, 16, "bwma", 1, 0, 1 << 22, 2 << 22, device=CPU)
    assert torch.unique(ta).numel() == torch.unique(tb).numel()


def test_bwma_trace_is_more_sequential():
    ta, _ = mm.gemm_trace(128, 128, 128, 16, "rwma", 1, 0, 1 << 22, 2 << 22, device=CPU)
    tb, _ = mm.gemm_trace(128, 128, 128, 16, "bwma", 1, 0, 1 << 22, 2 << 22, device=CPU)
    assert mm._sequential(tb).double().mean() > mm._sequential(ta).double().mean()


def test_dm_cache_sim_basics():
    assert int(mm._dm_miss(torch.zeros(100, dtype=torch.int64), 32 * 1024).sum()) == 1
    lines = torch.arange(10_000, dtype=torch.int64)
    assert int(mm._dm_miss(lines, 32 * 1024).sum()) == 10_000


def test_paper_effects_small_workload():
    accel = mm.AccelSpec.sa(16)
    r = mm.simulate_layer(SMALL, accel, "rwma", device=CPU)
    b = mm.simulate_layer(SMALL, accel, "bwma", device=CPU)
    assert r["total"].cycles > b["total"].cycles
    assert r["total"].l1_misses > b["total"].l1_misses
    assert r["total"].l2_accesses > b["total"].l2_accesses
    ng_r = sum(r[c].cycles for c in mm.NON_GEMM_COMPONENTS) / r["total"].cycles
    ng_b = sum(b[c].cycles for c in mm.NON_GEMM_COMPONENTS) / b["total"].cycles
    assert ng_b > ng_r


def test_multicore_scales_and_preserves_win():
    accel = mm.AccelSpec.sa(16)
    c1 = mm.simulate_layer(SMALL, accel, "bwma", cores=1, device=CPU)["total"].cycles
    c2 = mm.simulate_layer(SMALL, accel, "bwma", cores=2, device=CPU)["total"].cycles
    assert c2 < c1
    r2 = mm.simulate_layer(SMALL, accel, "rwma", cores=2, device=CPU)["total"].cycles
    assert c2 < r2


def test_conversion_overhead_is_negligible():
    assert mm.conversion_overhead_fraction(SMALL, mm.AccelSpec.sa(16), device=CPU) < 0.01


def test_chip_smoke_memmodel_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 18 on the CPU: its card-against-CPU checks (here
    CPU against CPU) and figures, at a reduced layer whose SA16x16 speedup
    lies inside the band (the full layer is the card's)."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    wl = mm.WorkloadConfig(seq=256, d_model=256, n_heads=4, d_head=64, d_ff=1024)
    fig6a = cs.memmodel_phase(torch, device=CPU, full=wl)
    assert set(fig6a) == set(ACCELS)
    assert fig6a["SA16x16"]["speedup"] == mm.speedup(wl, mm.AccelSpec.sa(16), device=CPU)
    assert cs.MM_SPEEDUP_BAND[0] < fig6a["SA16x16"]["speedup"] < cs.MM_SPEEDUP_BAND[1]
