"""The host-side plan of the shared GEMM loop (csrc/gemm_tile.cuh): which CTA
tile each product gets, and which kernel a row-major product takes.

The plan is Python so that it can be held here, without a card: every CTA
tile it picks must be one the CUDA source instantiates, span whole data
blocks, cover every output block exactly once, and keep the launch grid
within its limits.  The route test drives the wrappers' CUDA branch against
a stand-in library to pin which entry point each product reaches and with
which tile.
"""
import contextlib
import importlib
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build

# the modules, not the functions of the same names that the package exports
bg = importlib.import_module("repro_torch.kernels.bwma_gemm")
rg = importlib.import_module("repro_torch.kernels.rwma_gemm")

CUH = Path(bg.__file__).with_name("csrc") / "gemm_tile.cuh"

BLOCKED = [
    # (label, rows, cols, bm, bn, lead): BERT-base at batch 4 and 1, blocks 16
    # and 128 (the per-head Q/K/V product has lead batch x 12 and N = d_head)
    *[(f"bert b{b} B{B} {name}", 512 * B if name != "qkv" else 512,
       {"qkv": -(-64 // b) * b, "wo": 768, "w1": 3072, "w2": 768}[name], b, b,
       12 * B if name == "qkv" else 1)
      for b in (16, 128) for B in (4, 1) for name in ("qkv", "wo", "w1", "w2")],
    # blocks 8..128 with bm != bn, and ragged gm / gn
    ("bm 8 bn 128", 8 * 7, 128 * 3, 8, 128, 1),
    ("bm 128 bn 8", 128 * 3, 8 * 5, 128, 8, 2),
    ("bm 32 bn 64 ragged", 32 * 5, 64 * 3, 32, 64, 1),
    ("bm 64 bn 16 ragged", 64 * 3, 16 * 9, 64, 16, 6),
    ("bm 16 bn 32 ragged", 16 * 9, 32 * 5, 16, 32, 48),
    ("block 8 tiny", 16, 16, 8, 8, 3),
    ("block 16 one block", 16, 16, 16, 16, 1),
    ("block 8 large grid", 8 * 4096, 8 * 3, 8, 8, 1),
]

SERVING = [  # starcoder2-7b products of the rwma serving run: (M, K, N, tile)
    (M, k, n, t) for M, t in ((16, 16), (24, 24), (128, 128))
    for k, n in ((4608, 4608), (4608, 512), (4608, 18432), (18432, 4608))
]


def _covers_once(rows, cols, bm, bn, tile):
    """Count how often the grid of ``tile`` CTAs covers each bm x bn block."""
    cm, cn = tile
    gm, gn = math.ceil(rows / bm), math.ceil(cols / bn)
    count = [[0] * gn for _ in range(gm)]
    for by in range(math.ceil(rows / cm)):
        for bx in range(math.ceil(cols / cn)):
            blocks = [(i, j) for i in range(by * cm // bm, (by + 1) * cm // bm)
                      for j in range(bx * cn // bn, (bx + 1) * cn // bn) if i < gm and j < gn]
            assert blocks, f"CTA ({by}, {bx}) covers no block"
            for i, j in blocks:
                count[i][j] += 1
    return all(c == 1 for row in count for c in row)


def test_cta_tiles_match_the_cuda_dispatch():
    cases = re.findall(r"case (\d+): return launch<(\d+), (\d+), (\d+), (\d+),", CUH.read_text())
    tiles = {(int(cm), int(cn)) for _, cm, cn, _, _ in cases}
    assert tiles == set(bg.CTA_TILES)
    for key, cm, cn, tm, tn in cases:
        assert int(key) == int(cm) * 1000 + int(cn)
        threads = (int(cm) // int(tm)) * (int(cn) // int(tn))
        assert threads in (128, 256) and int(tn) % 4 == 0


@pytest.mark.parametrize("label,rows,cols,bm,bn,lead", BLOCKED, ids=[c[0] for c in BLOCKED])
def test_blocked_plan_covers_every_block_once(label, rows, cols, bm, bn, lead):
    cm, cn = bg.gemm_plan(rows, cols, bm, bn, lead)
    assert (cm, cn) in bg.CTA_TILES
    assert cm % bm == 0 and cn % bn == 0  # whole data blocks per CTA
    assert _covers_once(rows, cols, bm, bn, (cm, cn))
    assert math.ceil(rows / cm) <= 65535 and lead <= 65535


@pytest.mark.parametrize("M,K,N,tile", SERVING)
def test_serving_products_take_the_tile_loop(M, K, N, tile):
    route, (cm, cn) = rg.rwma_route(M, K, N, tile, tile)
    assert route == "tile_loop" and (cm, cn) in bg.CTA_TILES
    assert cm <= 32 if M <= 24 else cm == 128  # skinny products get short tiles
    assert _covers_once(M, N, 1, 1, (cm, cn)) if cm < 64 else _covers_once(M, N, tile, tile,
                                                                              (cm, cn))


@pytest.mark.parametrize("bm,bn", [(8, 8), (16, 16), (32, 64), (128, 128), (16, 128)])
def test_rwma_plan_is_the_blocked_plan_at_equal_tiling(bm, bn):
    rows, cols = bm * 12, bn * 6
    assert rg.rwma_route(rows, 256, cols, bm, bn) == ("tile_loop",
                                                      bg.gemm_plan(rows, cols, bm, bn))


@pytest.mark.parametrize("M,K,N,tile,route", [
    (27, 45, 18, 9, "any_tile"),      # K not a multiple of 4: no 16-byte rows
    (36, 24, 18, 6, "any_tile"),      # N not a multiple of 4
    (48, 72, 96, 24, "tile_loop"),    # tile 24: any row count, 16-byte rows
    (192, 384, 576, 192, "tile_loop"),
    (96, 96, 96, 96, "tile_loop"),
    (64, 48, 32, 8, "tile_loop"),
])
def test_rwma_route_by_shape(M, K, N, tile, route):
    got, plan = rg.rwma_route(M, K, N, tile, tile)
    assert got == route
    if route == "tile_loop":
        assert plan in bg.CTA_TILES and _covers_once(M, N, 1, 1, plan)
    else:
        assert plan is None


def test_plan_shrinks_to_narrow_and_skinny_products():
    # the per-head products (N = d_head = 64 at block 16) get a tile 64 wide
    assert bg.gemm_plan(512, 64, 16, 16, 48)[1] == 64
    # a 16-row product gets a 16-row tile
    assert bg.gemm_plan(16, 4608, 16, 16)[0] == 16
    # a large product gets the largest tile
    assert bg.gemm_plan(2048, 3072, 16, 16) == (128, 128)
    # 128-blocks leave only tiles that span them
    assert bg.gemm_plan(512, 128, 128, 128, 12) == (128, 128)
    with pytest.raises(ValueError, match="no CTA tile"):
        bg.gemm_plan(256, 256, 256, 8)


class _FakeLib:
    """Records the kernel entry points the wrappers call, and succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "on_cuda", lambda kernel, *t: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("M,K,N,tile,entry", [
    (27, 45, 18, 9, "rwma_any_tile_f32"), (48, 72, 96, 24, "rwma_gemm_f32"),
    (192, 384, 576, 192, "rwma_gemm_f32"), (64, 96, 128, 32, "rwma_gemm_f32")])
def test_rwma_wrapper_launches_its_route_once(fake_card, M, K, N, tile, entry):
    rg.rwma_gemm.launches = 0
    rg.rwma_gemm(torch.zeros(M, K), torch.zeros(K, N), bm=tile, bk=tile, bn=tile)
    assert [name for name, _ in fake_card.calls] == [entry]
    args = fake_card.calls[0][1]
    if entry == "rwma_gemm_f32":  # a, b, out, M, N, K, cm, cn, stream
        assert args[3:6] == (M, N, K)
        assert tuple(args[6:8]) == rg.rwma_route(M, K, N, tile, tile)[1]
    else:  # a, b, out, gm, gn, gk, bm, bn, bk, stream
        assert args[3:9] == (M // tile, N // tile, K // tile, tile, tile, tile)
    assert rg.rwma_gemm.launches == 1
    rg.rwma_gemm.launches = 0


@pytest.mark.parametrize("fused", [False, True])
def test_blocked_wrappers_pass_the_plan(fake_card, fused):
    import repro_torch.kernels as tk

    a = torch.zeros(2, 1, 5, 3, 16, 16)
    w = torch.zeros(12, 3, 4, 16, 16) if not fused else torch.zeros(3, 4, 16, 16)
    tk.reset_launch_counts()
    if fused:
        tk.bwma_fused_ffn(a[:, 0], w, torch.zeros(4, 16))
    else:
        tk.bwma_gemm(a, w)
    (name, args), = fake_card.calls
    assert name == ("bwma_fused_ffn_f32" if fused else "bwma_gemm_f32")
    lead = 2 if fused else 24
    # ..., gm, gn, gk, bm, bn, bk, cm, cn, stream
    assert args[-9:-3] == (5, 4, 3, 16, 16, 16)
    assert tuple(args[-3:-1]) == bg.gemm_plan(80, 64, 16, 16, lead)
    assert tk.launch_counts()["bwma_fused_ffn" if fused else "bwma_gemm"] == 1
    tk.reset_launch_counts()

