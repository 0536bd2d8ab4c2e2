"""The host-side plans of the blocked softmax (csrc/bwma_softmax.cu) and the
blocked transpose (csrc/bwma_transpose.cu), and emulators of their walks.

The plans are Python so that they can be held here, without a card: every
launch they give must be one the CUDA source instantiates and accepts, the
softmax's grid must give every logical row one warp and fill the card at the
BERT-base calls, and the transpose's tiles must cover every source block
exactly once.  Two emulators written here in plain PyTorch (test oracles
only: the CPU path of each wrapper still takes its plain version) follow the
kernels' order of work -- the looped softmax's running max and rescaled sum
in its vector order, the transpose's micro-tiles CTA by CTA -- and are held
against the JAX Pallas kernels in interpret mode.  The route tests drive
each wrapper's CUDA branch against a stand-in library to pin what reaches
the entry point.
"""
import contextlib
import importlib
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.bwma_softmax import bwma_softmax as jax_softmax
from repro.kernels.bwma_transpose import bwma_transpose as jax_transpose
from repro_torch.kernels import _build

sm = importlib.import_module("repro_torch.kernels.bwma_softmax")
tr = importlib.import_module("repro_torch.kernels.bwma_transpose")

CSRC = Path(_build.__file__).with_name("csrc")
SM_SRC = (CSRC / "bwma_softmax.cu").read_text()
TR_SRC = (CSRC / "bwma_transpose.cu").read_text()
DTYPES = [torch.float32, torch.bfloat16]
ELEM = {1: torch.uint8, 2: torch.bfloat16, 4: torch.float32, 8: torch.float64,
        16: torch.complex128}


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


ROWS = _const(SM_SRC, "kRows")  # softmax rows per CTA
CHUNK = _const(SM_SRC, "kChunk")  # vectors a lane loads at once, looped path
BF16_ROUNDING = 2.0 ** -7


def _vec(dtype):
    return 16 // dtype.itemsize  # elements of one 16-byte vector


# -- the softmax plan ---------------------------------------------------------

def test_softmax_plan_uses_only_what_the_cuda_source_instantiates():
    nv = {int(n) for n in re.findall(r"bwma_softmax_kernel<T, BN, (\d+)>", SM_SRC)}
    plans = [sm.softmax_plan(n, dt) for dt in DTYPES for n in range(8, 5000, 8)]
    assert {0 if looped else per_lane for per_lane, looped in plans} == nv
    assert nv == {0, 1, 2, 4, 8, 16}  # 0: the looped path
    assert _const(SM_SRC, "kMaxVectors") == 16
    bns = {int(b) for b in re.findall(r"case (\d+): launch<T, \1>", SM_SRC)}
    assert bns == set(_build.SUPPORTED_BLOCKS)
    assert ROWS in (4, 8) and CHUNK >= 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [8, 24, 128, 512, 640, 2048, 2056, 2176, 4096, 4104, 4224,
                               8192])
def test_softmax_looped_path_only_above_the_register_width(n, dtype):
    """A lane holds the power of two of vectors that covers the row, up to
    16; a row wider than 2048 fp32 or 4096 bf16 columns takes the looped
    path."""
    per_lane, looped = sm.softmax_plan(n, dtype)
    assert looped == (n > 16 * 32 * _vec(dtype))
    if not looped:
        assert 32 * per_lane * _vec(dtype) >= n
        assert per_lane == 1 or 32 * (per_lane // 2) * _vec(dtype) < n


def _softmax_rows(lead, gm, bm):
    """The kernel's grid, warp by warp: (CTA, warp) -> (block-row, row in it),
    for every warp that works (the last CTA's tail returns)."""
    rows = math.prod(lead) * gm * bm
    ctas = -(-rows // ROWS)
    g = torch.arange(ctas * ROWS)
    g = g[g < rows]
    return ctas, g // bm, g % bm


@pytest.mark.parametrize("lead,gm,bm", [((), 3, 6), ((2, 3), 5, 6), ((), 4, 16),
                                        ((4, 12), 32, 16), ((3,), 2, 128), ((4, 12), 4, 128),
                                        ((7,), 1, 6), ((1,), 1, 1)])
def test_softmax_grid_covers_every_logical_row_once(lead, gm, bm):
    """Rows, not block-rows, set the grid: a CTA may straddle two block-rows
    (bm 6 is not a multiple of kRows) and every logical row of every leading
    slot gets exactly one warp."""
    ctas, br, r = _softmax_rows(lead, gm, bm)
    seen = torch.zeros(math.prod(lead) * gm, bm, dtype=torch.int64)
    seen.index_put_((br, r), torch.ones_like(br), accumulate=True)
    assert torch.all(seen == 1)
    assert ctas * ROWS - br.numel() < ROWS  # only the last CTA has idle warps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [16, 128])
def test_softmax_bert_base_fills_the_card(block, dtype):
    """BERT-base scores, 4 x 12 heads of 512 x 512: 6144 CTAs at either
    block (a CTA per kRows rows, not per block-row), on the register path."""
    ctas, _, _ = _softmax_rows((4, 12), 512 // block, block)
    assert ctas == 4 * 12 * 512 // ROWS >= 132 * 8
    assert sm.softmax_plan(512, dtype) == (512 // (32 * _vec(dtype)), False)


def _looped_softmax(x, n_logical):
    """The looped path of csrc/bwma_softmax.cu in plain PyTorch: lane l of a
    row's warp walks vectors l + 32 (kChunk t + c); per chunk the running
    max takes the chunk's live columns and the running sum is rescaled to it,
    then grows by exp(x - m) in the lane's order; the lanes' maxima reduce,
    their sums are rescaled to the row max and reduced with the warp's
    butterfly; a second pass writes exp(x - max) / max(sum, 1e-30)."""
    dtype = x.dtype
    *lead, gm, gn, bm, bn = x.shape
    width, v = gn * bn, _vec(dtype)
    nvec = width // v
    rows = x.float().movedim(-3, -2).reshape(-1, nvec, v)  # (rows, vectors, V)
    live = (torch.arange(width) < n_logical).reshape(nvec, v)
    fill = torch.finfo(dtype).min if n_logical < width else -math.inf
    n = rows.shape[0]
    m = torch.full((n, 32), fill)
    s = torch.zeros(n, 32)
    lane = torch.arange(32)
    for v0 in range(0, nvec, 32 * CHUNK):
        vids = [v0 + lane + 32 * c for c in range(CHUNK)]  # (32,) each
        cm = m.clone()
        for vid in vids:
            ok = vid < nvec
            f = rows[:, vid.clamp(max=nvec - 1)]  # (n, 32, V)
            lv = live[vid.clamp(max=nvec - 1)] & ok[:, None]
            cm = torch.maximum(cm, torch.where(lv, f, -math.inf).amax(-1))
        up = cm > m
        s = torch.where(up, torch.where(s > 0, s * torch.exp(m - cm), 0.0), s)
        m = torch.where(up, cm, m)
        for vid in vids:
            ok = vid < nvec
            f = rows[:, vid.clamp(max=nvec - 1)]
            lv = live[vid.clamp(max=nvec - 1)] & ok[:, None]
            for e in range(v):
                s = s + torch.where(lv[:, e], torch.exp(f[..., e] - m), 0.0)
    mx = m.amax(-1, keepdim=True)
    t = torch.where(s > 0, s * torch.exp(m - mx), 0.0)
    for o in (16, 8, 4, 2, 1):
        t = t + t[:, lane ^ o]
    den = torch.clamp(t[:, :1, None], min=1e-30)
    y = torch.where(live, torch.exp(rows - mx[..., None]) / den, 0.0).to(dtype)
    return y.reshape(*lead, gm, bm, gn, bn).movedim(-2, -3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gn,n_logical", [(33, 33 * 128), (33, 4100), (40, 5000)])
def test_looped_softmax_emulator_matches_pallas(dtype, gn, n_logical):
    """Rows of 4224 and 5120 columns (looped in fp32 and bf16), full and
    ragged: fp32 within 2e-5 of the JAX kernel; bf16 within one bf16
    rounding of the JAX kernel run in fp32 on the same bf16 values (the
    Pallas kernel computes in its input's type; the port computes in fp32
    and rounds once)."""
    assert sm.softmax_plan(gn * 128, dtype)[1]  # the looped path
    rng = np.random.default_rng(gn + n_logical)
    x = torch.from_numpy(rng.standard_normal((2, 1, gn, 3, 128)).astype(np.float32) * 3)
    x = x.to(dtype)
    got = _looped_softmax(x, n_logical)
    want = torch.from_numpy(np.array(
        jax_softmax(jnp.asarray(x.float().numpy()), n_logical, interpret=True)))
    col = torch.arange(gn * 128).reshape(gn, 1, 128)
    assert torch.all(torch.where(col >= n_logical, got, 0) == 0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert got.dtype == torch.bfloat16
        assert torch.all((got.float() - want).abs() <= BF16_ROUNDING * want.abs() + 1e-6)
    torch.testing.assert_close(got.float(), sm.softmax_plain(x, n_logical).float(),
                               rtol=2e-5 if dtype == torch.float32 else BF16_ROUNDING,
                               atol=1e-6)


# -- the transpose plan -------------------------------------------------------

def test_transpose_plan_constants_are_the_sources():
    assert _const(TR_SRC, "kTileBytes") == tr.TILE_BYTES
    assert _const(TR_SRC, "kMaxTileRows") == tr.MAX_TILE_ROWS
    words = {int(w) for w in re.findall(r"case (\d+): (?:if constexpr \(ESZ <= \1\) )?"
                                        r"return launch<ESZ, \1>", TR_SRC)}
    sizes = {int(e) for e in re.findall(r"case (\d+): return by_word<\1>", TR_SRC)}
    assert words == set(tr.WORD_BYTES) and sizes | {16} == set(tr.WORD_BYTES)


def _transpose_walk(x, plan):
    """csrc/bwma_transpose.cu's walk in plain PyTorch: CTA -> its group of
    blocks and sub-tile, thread slot u -> (block, micro-tile row, micro-tile
    column), micro-tile rows fastest; each V x V micro-tile is copied to its
    transposed place.  Returns the output and how often each output element
    was written."""
    *lead, gm, gn, bm, bn = x.shape
    blocks = math.prod(lead) * gm * gn
    v = plan.word // x.element_size()
    mr_n, mc_n = bm // v, bn // v
    sr, sc, nb = plan.tile_rows // v, plan.tile_cols // v, plan.tile_blocks
    st_c, st_r = -(-mc_n // sc), -(-mr_n // sr)
    cta = torch.arange(plan.ctas)[:, None]
    u = torch.arange(nb * sr * sc)[None, :]
    g, st = cta // (st_r * st_c), cta % (st_r * st_c)
    bl, q = u // (sr * sc), u % (sr * sc)
    mr, mc = st // st_c * sr + q % sr, st % st_c * sc + q // sr
    blk = g * nb + bl
    ok = (blk < blocks) & (mr < mr_n) & (mc < mc_n)
    blk, mr, mc = blk[ok], mr[ok], mc[ok]
    lead_i, ij = blk // (gm * gn), blk % (gm * gn)
    ob = (lead_i * gn + ij % gn) * gm + ij // gn  # block (i, j) goes to (j, i)
    t = torch.arange(v)
    b, o, r, c = torch.broadcast_tensors(  # each (micro-tiles, V, V)
        blk[:, None, None], ob[:, None, None],
        (mr * v)[:, None, None] + t[None, :, None],  # source row = output column
        (mc * v)[:, None, None] + t[None, None, :])  # source column = output row
    out = torch.zeros(blocks, bn, bm, dtype=x.dtype)
    count = torch.zeros(blocks, bn, bm, dtype=torch.int64)
    out[o, c, r] = x.reshape(blocks, bm, bn)[b, r, c]
    count.index_put_((o, c, r), torch.ones_like(o), accumulate=True)
    return out.reshape(*lead, gn, gm, bn, bm), count


# (lead, gm, gn, bm, bn): square, the BERT-base K shapes, rectangular and odd
SHAPES = [((), 3, 5, 16, 16), ((4, 12), 32, 4, 16, 16), ((4, 12), 4, 1, 128, 128),
          ((2,), 3, 2, 8, 32), ((1,), 2, 3, 64, 64), ((2,), 3, 2, 24, 40),
          ((3,), 2, 5, 1, 7), ((2,), 5, 3, 6, 10), ((), 2, 2, 128, 40)]


@pytest.mark.parametrize("esz", sorted(ELEM))
@pytest.mark.parametrize("lead,gm,gn,bm,bn", SHAPES)
def test_transpose_plan_covers_every_block_exactly_once(esz, lead, gm, gn, bm, bn):
    """Every output element is written exactly once, by a tile of at most
    kTileBytes with at most kMaxTileRows micro-tile rows; blocks that fit
    whole move whole, several to a CTA."""
    plan = tr.transpose_plan(gm, gn, bm, bn, esz, math.prod(lead))
    v = plan.word // esz
    assert plan.word in tr.WORD_BYTES and plan.word >= esz
    assert (bm * esz) % plan.word == 0 and (bn * esz) % plan.word == 0
    assert plan.tile_blocks * plan.tile_rows * plan.tile_cols * esz <= tr.TILE_BYTES
    assert plan.tile_rows // v <= tr.MAX_TILE_ROWS
    assert plan.tile_blocks == 1 or (plan.tile_rows, plan.tile_cols) == (bm, bn)
    _, count = _transpose_walk(torch.zeros(*lead, gm, gn, bm, bn, dtype=ELEM[esz]), plan)
    assert torch.all(count == 1)


@pytest.mark.parametrize("esz,align,word", [(4, 16, 16), (4, 8, 8), (4, 4, 4), (2, 2, 2),
                                            (1, 1, 1), (16, 16, 16)])
def test_transpose_word_follows_the_address(esz, align, word):
    """An input address that is not 16-byte aligned narrows the word."""
    assert tr.transpose_plan(4, 1, 128, 128, esz, 48, align).word == word


@pytest.mark.parametrize("esz,block,plan", [
    # BERT-base K, 4 x 12 heads of 512 x 64: whole blocks at block 16, a
    # sub-tile at 128 (8 or 4 per block); 8 KB a CTA
    (4, 16, (16, 8, 16, 16, 768)), (2, 16, (16, 16, 16, 16, 384)),
    (4, 128, (16, 1, 64, 32, 1536)), (2, 128, (16, 1, 128, 32, 768))])
def test_transpose_bert_base_plan_is_pinned(esz, block, plan):
    gm, gn = 512 // block, -(-64 // block)
    assert tuple(tr.transpose_plan(gm, gn, block, block, esz, 48)) == plan


@pytest.mark.parametrize("lead,gm,gn,bm,bn", [((2,), 3, 2, 16, 16), ((), 2, 1, 128, 128),
                                              ((2,), 3, 2, 24, 40), ((3,), 2, 5, 8, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_transpose_walk_matches_pallas_bit_exact(lead, gm, gn, bm, bn, dtype):
    """The emulated walk against the JAX kernel in interpret mode at block
    16, block 128 and rectangular layouts, bit for bit."""
    rng = np.random.default_rng(gm * bm + bn)
    x32 = rng.standard_normal((*lead, gm, gn, bm, bn)).astype(np.float32) * 50
    x = torch.from_numpy(x32).to(dtype)
    plan = tr.transpose_plan(gm, gn, bm, bn, x.element_size(), math.prod(lead))
    got, count = _transpose_walk(x, plan)
    bits, jdt = ((torch.int16, jnp.bfloat16) if dtype == torch.bfloat16
                 else (torch.int32, jnp.float32))
    jx = jnp.asarray(x.view(bits).numpy()).view(jdt)  # the same bits
    want = jax_transpose(jx, interpret=True).view(jnp.int16 if jdt == jnp.bfloat16
                                                  else jnp.int32)
    assert torch.all(count == 1)
    np.testing.assert_array_equal(got.view(bits).numpy(), np.asarray(want))
    assert torch.equal(got.view(bits), tr.transpose_plain(x).view(bits))


# -- the wrappers' CUDA branch against a stand-in library --------------------

class _FakeLib:
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
    sm.bwma_softmax.launches = tr.bwma_transpose.launches = 0
    yield lib
    sm.bwma_softmax.launches = tr.bwma_transpose.launches = 0


@pytest.mark.parametrize("lead,gm,gn,block,dtype", [
    ((4, 12), 32, 32, 16, torch.float32), ((4, 12), 4, 4, 128, torch.bfloat16),
    ((2,), 1, 17, 128, torch.float32), ((), 2, 33, 128, torch.bfloat16),
    ((3,), 5, 3, 8, torch.bfloat16)])
def test_softmax_route_passes_the_plan(fake_card, lead, gm, gn, block, dtype):
    x = torch.zeros(*lead, gm, gn, block, block, dtype=dtype)
    n = gn * block - 3
    sm.bwma_softmax(x, n)
    (name, args), = fake_card.calls
    per_lane, looped = sm.softmax_plan(gn * block, dtype)
    assert name == ("bwma_softmax_f32" if dtype == torch.float32 else "bwma_softmax_bf16")
    assert args[2:8] == (math.prod(lead) * gm, gn, block, block, n, 0 if looped else per_lane)
    assert looped == (gn in (17, 33))
    assert sm.bwma_softmax.launches == 1


@pytest.mark.parametrize("lead,gm,gn,bm,bn,dtype", [
    ((4, 12), 32, 4, 16, 16, torch.float32), ((4, 12), 4, 1, 128, 128, torch.bfloat16),
    ((2,), 3, 2, 24, 40, torch.float64), ((), 2, 3, 1, 7, torch.uint8)])
def test_transpose_route_passes_the_plan(fake_card, lead, gm, gn, bm, bn, dtype):
    x = torch.zeros(*lead, gm, gn, bm, bn, dtype=dtype)
    out = tr.bwma_transpose(x)
    (name, args), = fake_card.calls
    plan = tr.transpose_plan(gm, gn, bm, bn, x.element_size(), math.prod(lead))
    assert name == "bwma_transpose" and tuple(out.shape) == (*lead, gn, gm, bn, bm)
    assert args[2:9] == (x.element_size(), plan.word, math.prod(lead) * gm * gn, gm, gn, bm, bn)
    assert args[9:12] == plan[1:4]
    assert tr.bwma_transpose.launches == 1
