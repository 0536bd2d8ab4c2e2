"""The host-side plan of the fused attention kernel (csrc/bwma_attention.cu):
which CTA tile of query rows and keys each call gets -- one per padded head
width.

The plan is Python so that it can be held here, without a card: every tile
it gives must be one the CUDA source instantiates, fit the shared memory of
one CTA, cover every query row exactly once, and keep the launch grid within
its limits.  The route test drives
the wrapper's CUDA branch against a stand-in library to pin the tile and
the entry point it reaches.
"""
import contextlib
import importlib
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build

ba = importlib.import_module("repro_torch.kernels.bwma_attention")

CU = Path(ba.__file__).with_name("csrc") / "bwma_attention.cu"
SMS = 132
SMEM_PER_SM = 228 * 1024  # an H100 SM's shared memory; each CTA also holds 1 KB


def _smem_bytes(dp, bq, bkv):
    """Shared memory of one CTA as the kernel lays it out (its ``Tile``): the
    Q tile, two ring stages of K and V, and the probabilities, rows padded."""
    return 4 * (bq * (dp + 4) + 2 * 2 * bkv * (dp + 4) + bq * (bkv + 16))


CALLS = [
    # (label, rows = gs * bm, width = gd * bd, lead): BERT-base at batch 4 and 1,
    # blocks 16 (d_head 64) and 128 (d_head 64 padded to 128), then ragged
    # and small shapes, widths up to 256, and the largest lead
    ("bert b16 B4", 512, 64, 48), ("bert b16 B1", 512, 64, 12),
    ("bert b128 B4", 512, 128, 48), ("bert b128 B1", 512, 128, 12),
    ("ragged b16", 48, 32, 4), ("block 8 width 24", 32, 24, 3),
    ("block 128 one block", 128, 128, 2), ("width 256", 192, 256, 2),
    ("long sequence", 8192, 64, 1), ("many heads", 64, 64, 65535),
]


def test_attn_tiles_match_the_cuda_dispatch():
    cases = re.findall(r"case (\d+): return run\(Tile<(\d+), (\d+), (\d+)>\{\}\);",
                       CU.read_text())
    tiles = {int(dp): (int(bq), int(bkv)) for _, bq, bkv, dp in cases}
    assert tiles == ba.ATTN_TILES and len(cases) == len(tiles)
    for key, bq, bkv, dp in cases:
        assert int(key) == int(dp) * 1000000 + int(bq) * 1000 + int(bkv)


@pytest.mark.parametrize("tile", list(ba.ATTN_TILES))
def test_attn_tile_fits_one_cta_with_the_claimed_occupancy(tile):
    dp = tile
    bq, bkv = ba.ATTN_TILES[dp]
    smem = _smem_bytes(dp, bq, bkv)
    assert smem <= ba.MAX_SHARED_BYTES
    # two CTAs share an SM at width 64 (the kernel's launch bounds), one above
    assert (2 * (smem + 1024) <= SMEM_PER_SM) == (dp == 64)
    # a 16 x 16 thread grid: whole rows and keys per thread, 4-column groups
    assert bq % 16 == 0 and bkv % 16 == 0 and dp % 64 == 0
    assert (bq // 16) * (dp // 16) <= 64  # output registers per thread


@pytest.mark.parametrize("label,rows,width,lead", CALLS, ids=[c[0] for c in CALLS])
def test_attention_plan_covers_every_query_row_once(label, rows, width, lead):
    bq, bkv = ba.attention_plan(width)
    dp = ba.padded_width(width)
    assert ba.ATTN_TILES[dp] == (bq, bkv) and width <= dp
    ctas = math.ceil(rows / bq)
    # CTA x owns rows [x * bq, (x + 1) * bq): every row once, the last CTA
    # partly past the rows
    assert (ctas - 1) * bq < rows <= ctas * bq
    assert ctas <= 2 ** 31 - 1 and lead <= 65535


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("lead", [48, 12])
def test_plan_takes_the_fastest_measured_tile_at_bert_base(width, lead):
    """At BERT-base (512 rows, d_head 64 at blocks 16 and 128, batch 4 and 1)
    a tile of 64 query rows and 64 keys was the fastest or within 3% of it
    on the card (PERF.md), and the wrapper launches it at every lead."""
    assert ba.attention_plan(width) == (64, 64)


@pytest.mark.parametrize("width,dp", [(8, 64), (24, 64), (64, 64), (65, 128), (96, 128),
                                      (128, 128), (129, 256), (192, 256), (256, 256)])
def test_padded_width_is_the_least_instantiated_width(width, dp):
    assert ba.padded_width(width) == dp
    assert ba.attention_plan(width) == ba.ATTN_TILES[dp]


def test_plan_refuses_heads_wider_than_256_columns():
    with pytest.raises(ValueError, match="above 256"):
        ba.attention_plan(264)


@pytest.fixture(autouse=True)
def _fresh_counts():
    """The stand-in launches below count as launches; leave none behind."""
    import repro_torch.kernels as tk

    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()


class _FakeLib:
    """Records the kernel entry points the wrapper calls, and succeeds."""

    def __init__(self):
        self.calls = []

    def bwma_attention_smem_bytes(self, dp, bq, bkv):
        return _smem_bytes(dp, bq, bkv) if ba.ATTN_TILES.get(dp) == (bq, bkv) else -1

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


@pytest.mark.parametrize("lq,lkv,gs,gd,block", [((2, 3), (2, 3), 4, 4, 16),
                                                ((3,), (1,), 2, 1, 128),
                                                ((2,), (2,), 3, 2, 128)])
def test_attention_wrapper_passes_the_plan(fake_card, lq, lkv, gs, gd, block):
    import repro_torch.kernels as tk

    q = torch.zeros(*lq, gs, gd, block, block)
    kv = torch.zeros(*lkv, gs, gd, block, block)
    tk.reset_launch_counts()
    out = tk.bwma_attention(q, kv, kv, scale=0.5, s_logical=gs * block - 3)
    assert tuple(out.shape) == tuple(q.shape)
    (name, args), = fake_card.calls
    assert name == "bwma_attention_f32"
    assert args[4] * args[5] == math.prod(lq)  # the (batch, head) slots
    # ..., gs, gd, bm, bd, padded width, bq, bkv, s_logical, scale, stream
    assert args[-10:-5] == (gs, gd, block, block, ba.padded_width(gd * block))
    assert tuple(args[-5:-3]) == ba.attention_plan(gd * block)
    assert args[-3] == gs * block - 3
    assert tk.launch_counts()["bwma_attention"] == 1
    tk.reset_launch_counts()


def test_attention_wrapper_refuses_wide_heads_on_the_card(fake_card):
    import repro_torch.kernels as tk

    q = torch.zeros(1, 3, 64, 64)  # d_head 192 pads to 256: runs
    tk.bwma_attention(q, q, q, scale=1.0, s_logical=64)
    wide = torch.zeros(2, 3, 128, 128)  # 384 columns: no tile
    with pytest.raises(ValueError, match="above 256"):
        tk.bwma_attention(wide, wide, wide, scale=1.0, s_logical=200)
    assert [name for name, _ in fake_card.calls] == ["bwma_attention_f32"]
    # the CPU path (the plain version) takes any width
    out = ba.attention_plain(wide, wide, wide, scale=1.0, s_logical=200)
    assert tuple(out.shape) == tuple(wide.shape)
