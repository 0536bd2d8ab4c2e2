"""The split plan of the paged GQA decode kernel (csrc/paged_attention.cu),
on the CPU.

The kernel splits each slot's history into runs of ``kSplitKeys`` keys, one
CTA each, and merges the runs' partial softmaxes in a combine pass.  The
plan is Python (:func:`decode_plan`) so that it can be held here, without a
card: it must cover every key once, whatever B and the other slots'
positions, and refuse a grid the card cannot launch.  A plain emulator of
the split and the combine (partials per split in 32-key tiles, then the
merge in ascending split order) is held against the JAX package's Pallas
kernel in interpret mode, fp32 within 1e-6 and bf16 within one bf16
rounding (2^-7 of the output) plus 1e-6, the gates of the kernel itself.
The emulator is a test oracle only: the CPU path takes ``decode_plain``.
A route test drives the wrapper's CUDA branch against a stand-in library to
pin what reaches the entry point.  Inputs come from a numpy seed.
"""
import contextlib
import importlib
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.kernels import _build

pa = importlib.import_module("repro_torch.kernels.paged_attention")

CU = Path(pa.__file__).with_name("csrc") / "paged_attention.cu"
SRC = CU.read_text()
SPLIT = int(re.search(r"constexpr int kSplitKeys = (\d+);", SRC).group(1))
TILE = int(re.search(r"constexpr int kTileKeys = (\d+);", SRC).group(1))
TOL = 1e-6
BF16_ROUNDING = 2.0 ** -7


def test_plan_reads_the_sources_constants():
    assert pa.SPLIT_KEYS == SPLIT and SPLIT % TILE == 0 and SPLIT in (128, 256)
    assert re.search(r"constexpr int kStages = 2;", SRC)  # a two-stage cp.async ring
    dim_chunks = int(re.search(r"constexpr int kMaxDimChunks = (\d+);", SRC).group(1))
    assert pa.MAX_HEAD_DIM == 64 * dim_chunks
    assert "atomic" not in SRC[SRC.index("paged_decode_kernel"):SRC.index("mla_decode_kernel")]


def _split_ranges(n_keys, split_keys, splits):
    """The key ranges the kernel's CTAs of one slot own (the others return)."""
    return [(z * split_keys, min((z + 1) * split_keys, n_keys)) for z in range(splits)
            if z * split_keys < n_keys]


@pytest.mark.parametrize("page", [8, 16, 100, 128, 256, 512])
@pytest.mark.parametrize("maxp", [1, 3, 16, 64])
def test_plan_covers_every_key_once(page, maxp):
    split_keys, splits = pa.decode_plan(page, maxp)
    reach = page * maxp
    assert split_keys == SPLIT and (splits - 1) * split_keys < reach <= splits * split_keys
    for n_keys in sorted({1, SPLIT - 1, SPLIT, SPLIT + 1, page, reach // 2 + 1, reach}):
        if n_keys > reach:
            continue
        ranges = _split_ranges(n_keys, split_keys, splits)
        keys = [k for lo, hi in ranges for k in range(lo, hi)]
        assert keys == list(range(n_keys))  # each key once, in ascending splits
        assert all(hi - lo == split_keys for lo, hi in ranges[:-1])


@pytest.mark.parametrize("page,maxp", [(16, 4), (128, 16), (256, 3)])
def test_plan_is_the_same_for_any_batch_and_positions(page, maxp):
    """The plan takes no B and no seq_pos: a slot's ranges depend on its own
    key count alone, and a wider table (null-page columns) keeps them."""
    split_keys, splits = pa.decode_plan(page, maxp)
    wide_keys, wide_splits = pa.decode_plan(page, 2 * maxp)
    assert wide_keys == split_keys and wide_splits >= splits
    for n_keys in range(1, page * maxp + 1, 7):
        assert _split_ranges(n_keys, split_keys, splits) == \
            _split_ranges(n_keys, wide_keys, wide_splits)


def test_plan_refuses_a_grid_over_65535():
    assert pa.decode_plan(SPLIT, 65535) == (SPLIT, 65535)
    assert pa.decode_plan(1, 65535 * SPLIT) == (SPLIT, 65535)
    with pytest.raises(ValueError, match="65535"):
        pa.decode_plan(SPLIT, 65536)
    with pytest.raises(ValueError, match="65535"):
        pa.decode_plan(1, 65535 * SPLIT + 1)


def emulate(q, k_pages, v_pages, table, seq_pos, scale=None):
    """The kernel's algorithm in plain PyTorch: per slot and split, an fp32
    online softmax over 32-key tiles gives (m, l, acc); the combine merges
    the splits in ascending order with the same rescale, divides and rounds
    once to q's type."""
    B, _, H, dh = q.shape
    _, page, hkv, _ = k_pages.shape
    maxp = table.shape[1]
    G = H // hkv
    split_keys, splits = pa.decode_plan(page, maxp)
    scale = dh ** -0.5 if scale is None else scale
    out = torch.zeros(B, H, dh)
    for b in range(B):
        n_keys = min(int(seq_pos[b]) + 1, maxp * page)
        keys = torch.arange(n_keys)
        pages = table[b].long()[keys // page]
        kb = k_pages[pages, keys % page].float()  # (n, hkv, dh)
        vb = v_pages[pages, keys % page].float()
        qb = q[b, 0].float().reshape(hkv, G, dh)
        parts = []
        for lo, hi in _split_ranges(n_keys, split_keys, splits):
            m = torch.full((hkv, G), pa.MASK)
            den = torch.zeros(hkv, G)
            acc = torch.zeros(hkv, G, dh)
            for t0 in range(lo, hi, TILE):
                t1 = min(t0 + TILE, hi)
                s = torch.einsum("hgd,thd->hgt", qb, kb[t0:t1]) * scale
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                den = den * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("hgt,thd->hgd", p, vb[t0:t1])
                m = m_new
            parts.append((m, den, acc))
        m = torch.stack([pm for pm, _, _ in parts]).amax(0)
        den = torch.zeros(hkv, G)
        acc = torch.zeros(hkv, G, dh)
        for pm, pden, pacc in parts:  # ascending split order
            f = torch.exp(pm - m)
            den = den + pden * f
            acc = acc + pacc * f[..., None]
        out[b] = (acc / den[..., None]).reshape(H, dh)
    return out[:, None].to(q.dtype)


def _case(B, H, hkv, dh, page, maxp, seq_pos, seed=0):
    """numpy inputs: distinct physical pages for each slot's used pages,
    null page 0 in every table column past its seq_pos."""
    rng = np.random.default_rng(seed)
    num_pages = B * maxp + 1
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, num_pages))
    for b, pos in enumerate(seq_pos):
        used = pos // page + 1
        table[b, :used] = phys[b * maxp:b * maxp + used]
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((num_pages, page, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((num_pages, page, hkv, dh)).astype(np.float32)
    return q, k, v, table, np.asarray(seq_pos, np.int32)


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return (got - want).abs().max().item() <= TOL
    return bool(torch.all((got - want).abs() <= BF16_ROUNDING * want.abs() + TOL))


EDGES = [0, SPLIT - 2, SPLIT - 1, SPLIT]  # slots of 1, SPLIT-1, SPLIT, SPLIT+1 keys

PALLAS_CASES = [
    # (H, hkv, dh, page, maxp, seq_pos): G 1, 8, 9; dh 64, 128; null-page
    # columns past every seq_pos; pages of 256 (a split ends mid-page)
    (2, 2, 64, 16, SPLIT // 16 + 3, EDGES),
    (8, 1, 64, 16, SPLIT // 16 + 3, EDGES),
    (18, 2, 128, 16, (SPLIT + 300) // 16 + 2, EDGES + [SPLIT + 300]),
    (9, 1, 128, 256, 2, [0, SPLIT - 1, SPLIT, 300, 511]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hkv,dh,page,maxp,seq_pos", PALLAS_CASES)
def test_emulator_matches_pallas(H, hkv, dh, page, maxp, seq_pos, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.paged_attention import paged_attention_decode as jax_decode

    q, k, v, table, pos = _case(len(seq_pos), H, hkv, dh, page, maxp, seq_pos)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_decode(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                      jnp.asarray(table), jnp.asarray(pos), interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = emulate(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                  torch.from_numpy(table), torch.from_numpy(pos))
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    assert _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hkv,dh,page,maxp,seq_pos", [
    (4, 4, 16, 8, 40, [0, 7, 8, 300]),
    (16, 2, 64, 32, SPLIT // 16 + 2, [SPLIT - 1, SPLIT, 2 * SPLIT - 1, 2 * SPLIT, 383]),
    (36, 4, 128, 128, 16, [0, 127, 1000, 1900]),  # starcoder2-7b decode shapes
    (34, 1, 12, 8, 20, [0, 77, 159]),  # G over a CTA's 16 heads; dh of 12
])
def test_emulator_matches_decode_plain(H, hkv, dh, page, maxp, seq_pos, dtype):
    """The split and the combine against the CPU path's plain version, more
    shapes than the Pallas interpreter can take in time."""
    q, k, v, table, pos = _case(len(seq_pos), H, hkv, dh, page, maxp, seq_pos, seed=1)
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)] + \
        [torch.from_numpy(table), torch.from_numpy(pos)]
    want = pa.decode_plain(*args)
    assert _close(emulate(*args), want, dtype)
    assert torch.equal(pa.paged_attention_decode(*args), want)  # the CPU path: plain


def test_emulator_is_batch_invariant():
    """A slot alone, in a batch, and behind null-page columns: the same bits."""
    q, k, v, table, pos = _case(3, 8, 2, 32, 16, 24, [5, 300, SPLIT])
    args = [torch.from_numpy(x) for x in (q, k, v, table, pos)]
    full = emulate(*args)
    wide = torch.cat([args[3], torch.zeros_like(args[3])], 1)
    wider = emulate(*args[:3], wide, args[4])
    for b in range(3):
        alone = emulate(args[0][b:b + 1], args[1], args[2], args[3][b:b + 1], args[4][b:b + 1])
        assert torch.equal(alone[0], full[b]) and torch.equal(wider[b], full[b])


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
    monkeypatch.setattr(pa, "_workspaces", {})
    pa.paged_attention_decode.launches = 0
    yield lib
    pa.paged_attention_decode.launches = 0


@pytest.mark.parametrize("dtype,entry", [(torch.float32, "paged_attention_decode_f32"),
                                         (torch.bfloat16, "paged_attention_decode_bf16")])
@pytest.mark.parametrize("B,H,hkv,dh,page,maxp", [(4, 36, 4, 128, 128, 16),
                                                  (1, 6, 6, 64, 16, 513),
                                                  (3, 4, 2, 16, 8, 5)])
def test_route_passes_the_plan_and_a_workspace(fake_card, dtype, entry, B, H, hkv, dh, page,
                                               maxp):
    q = torch.zeros(B, 1, H, dh, dtype=dtype)
    pool = torch.zeros(2, page, hkv, dh, dtype=dtype)
    table = torch.zeros(B, maxp, dtype=torch.int32)
    seq = torch.zeros(B, dtype=torch.int32)
    out = pa.paged_attention_decode(q, pool, pool, table, seq, scale=0.5)
    (name, args), = fake_card.calls
    splits = pa.decode_plan(page, maxp)[1]
    assert name == entry and out.shape == q.shape and out.dtype == dtype
    assert args[7:14] == (B, H, hkv, dh, page, maxp, splits) and args[14] == 0.5
    ws, = pa._workspaces.values()  # one partials buffer, reused by the next call
    assert args[6] == ws.data_ptr() and ws.dtype == torch.float32
    assert ws.numel() == B * H * splits * (dh + 2)
    pa.paged_attention_decode(q, pool, pool, table, seq, scale=0.5)
    assert fake_card.calls[1][1][6] == ws.data_ptr()
    assert pa.paged_attention_decode.launches == 2  # two kernels, one launch a call


def test_route_refuses_what_the_kernel_cannot_take(fake_card):
    table = torch.zeros(1, 4, dtype=torch.int32)
    seq = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="dh up to 256"):
        pa.paged_attention_decode(torch.zeros(1, 1, 2, 264), torch.zeros(2, 8, 2, 264),
                                  torch.zeros(2, 8, 2, 264), table, seq)
    with pytest.raises(ValueError, match="65535"):
        pa.paged_attention_decode(torch.zeros(1, 1, 2, 8), torch.zeros(2, 8, 2, 8),
                                  torch.zeros(2, 8, 2, 8),
                                  torch.zeros(1, 65535 * SPLIT // 8 + 1, dtype=torch.int32), seq)
    assert not fake_card.calls and pa.paged_attention_decode.launches == 0
