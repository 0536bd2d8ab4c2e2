"""The split plan of the MLA paged decode kernel (csrc/paged_attention.cu),
on the CPU.

The kernel splits each slot's history into runs of ``kSplitKeys`` keys (256
for fp32 pools, 128 for bf16), one CTA per run and chunk of ``kMlaHeads``
query heads, and merges the
runs' partial softmaxes in a combine pass, as the GQA decode does.  The plan
is Python (:func:`mla_decode_plan`) so that it can be held here, without a
card: it must cover every key once, whatever B and the other slots'
positions, and refuse a grid the card cannot launch.  A plain emulator of
the split and the combine -- partials per split in the kernel's tiles
(16 keys for fp32 pools, 32 for bf16), fp64 sums for fp32 pools, fp32 sums
and the probabilities in three bf16 parts for bf16 pools, then the merge in
ascending split order -- is held against the JAX package's Pallas kernel in
interpret mode at smoke widths (fp32 within 1e-6, bf16 within one bf16
rounding, 2^-7 of the output, plus 1e-6: the gates of the kernel itself)
and against ``mla_decode_plain`` at DeepSeek-V3 width.  The emulator is a
test oracle only: the CPU path takes ``mla_decode_plain``.  A route test
drives the wrapper's CUDA branch against a stand-in library to pin what
reaches the entry point.  Inputs come from a numpy seed.
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
MLA_SRC = SRC[SRC.index("constexpr int kMlaThreads"):SRC.index("paged_copy_kernel")]


def _const(name, text=MLA_SRC):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _math(type_name):
    """The kernel's ``MlaMath<type_name>`` constants."""
    body = MLA_SRC[MLA_SRC.index(f"struct MlaMath<{type_name}> {{"):]
    return {k: _const(k, body[:body.index("};")])
            for k in ("kSplitKeys", "kTileKeys", "kStages", "kDimGroups", "kStep")}


MATH = {torch.float32: _math("float"), torch.bfloat16: _math("__nv_bfloat16")}
SPLIT = {dt: m["kSplitKeys"] for dt, m in MATH.items()}
HEADS = _const("kMlaHeads")
PARTS = _const("kMlaPParts")
TILE = {dt: m["kTileKeys"] for dt, m in MATH.items()}
DTYPES = [torch.float32, torch.bfloat16]
TOL = 1e-6
BF16_ROUNDING = 2.0 ** -7


def test_plan_reads_the_sources_constants():
    assert pa.MLA_SPLIT_KEYS == SPLIT and set(SPLIT.values()) <= {128, 256}
    assert all(SPLIT[dt] % TILE[dt] == 0 and SPLIT[dt] <= 256 for dt in DTYPES)
    assert all(m["kStages"] >= 2 for m in MATH.values())  # a ring of two stages or more
    assert HEADS == 16 and PARTS == 3
    assert pa.MLA_MAX_LATENT == _const("kMlaMaxLatent")
    assert pa.MLA_MAX_DIMS == _const("kMlaMaxDims")
    assert "atomic" not in MLA_SRC  # an ordered combine, no atomics
    assert "cp.async" in SRC[SRC.index("void copy_word"):SRC.index("cp_async_commit")]
    # the ring: bulk copies (the Tensor Memory Accelerator) completing an
    # mbarrier a stage, cp.async words arriving on it where rows are narrower
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in MLA_SRC
    assert "cp.async.mbarrier.arrive.noinc" in MLA_SRC and "copy_word(" in MLA_SRC
    assert "mbarrier.try_wait.parity" in MLA_SRC
    # the tensor cores: fp64 m16n8k8 for fp32 pools, bf16 m16n8k16 for bf16
    assert "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64" in MLA_SRC
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in MLA_SRC
    for m in MATH.values():
        assert pa.MLA_MAX_DIMS % (m["kStep"] * m["kDimGroups"]) == 0


def _split_ranges(n_keys, split_keys, splits):
    """The key ranges the kernel's CTAs of one slot own (the others return)."""
    return [(z * split_keys, min((z + 1) * split_keys, n_keys)) for z in range(splits)
            if z * split_keys < n_keys]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("page", [8, 16, 100, 128, 256, 512])
@pytest.mark.parametrize("maxp", [1, 3, 16, 64])
def test_plan_covers_every_key_once(page, maxp, dtype):
    split_keys, splits = pa.mla_decode_plan(page, maxp, dtype)
    reach = page * maxp
    sk = SPLIT[dtype]
    assert split_keys == sk and (splits - 1) * split_keys < reach <= splits * split_keys
    for n_keys in sorted({1, sk - 1, sk, sk + 1, page, reach // 2 + 1, reach}):
        if n_keys > reach:
            continue
        ranges = _split_ranges(n_keys, split_keys, splits)
        keys = [k for lo, hi in ranges for k in range(lo, hi)]
        assert keys == list(range(n_keys))  # each key once, in ascending splits
        assert all(hi - lo == split_keys for lo, hi in ranges[:-1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_is_the_same_for_any_batch_and_positions(dtype):
    """The plan takes no B and no seq_pos; a wider table keeps the ranges."""
    split_keys, splits = pa.mla_decode_plan(128, 16, dtype)
    wide_keys, wide_splits = pa.mla_decode_plan(128, 32, dtype)
    assert wide_keys == split_keys and wide_splits == 2 * splits
    for n_keys in range(1, 128 * 16 + 1, 11):
        assert _split_ranges(n_keys, split_keys, splits) == \
            _split_ranges(n_keys, wide_keys, wide_splits)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_refuses_a_grid_over_65535(dtype):
    sk = SPLIT[dtype]
    assert pa.mla_decode_plan(sk, 65535, dtype) == (sk, 65535)
    with pytest.raises(ValueError, match="65535"):
        pa.mla_decode_plan(sk, 65536, dtype)
    with pytest.raises(ValueError, match="65535"):
        pa.mla_decode_plan(1, 65535 * sk + 1, dtype)


def _bf16_parts(p):
    """p as the kernel's kMlaPParts bf16 parts, each rounding the rest."""
    parts, rest = [], p
    for _ in range(PARTS):
        x = rest.to(torch.bfloat16).float()
        parts.append(x)
        rest = rest - x
    return parts


def emulate(q_lat, q_rope, ckv, krope, table, seq_pos, scale):
    """The kernel's algorithm in plain PyTorch: per slot and split, an online
    softmax over the kernel's tiles gives (m, l, acc) in the accumulation
    type, acc kept in fp32 between the kernels; the combine merges the splits
    in ascending order in the accumulation type, divides and rounds once to
    the pools' type."""
    dtype = ckv.dtype
    acc_t = torch.float64 if dtype == torch.float32 else torch.float32
    tile = TILE[dtype]
    B, _, H, r = q_lat.shape
    page, maxp = ckv.shape[1], table.shape[1]
    split_keys, splits = pa.mla_decode_plan(page, maxp, dtype)
    scale = torch.tensor(scale, dtype=torch.float32).item()
    out = torch.zeros(B, H, r, dtype=torch.float32)
    for b in range(B):
        n_keys = min(int(seq_pos[b]) + 1, maxp * page)
        keys = torch.arange(n_keys)
        pages = table[b].long()[keys // page]
        kv = torch.cat([ckv[pages, keys % page], krope[pages, keys % page]], -1).to(acc_t)
        q = torch.cat([q_lat[b, 0], q_rope[b, 0]], -1).to(acc_t)  # (H, r + dr)
        parts = []
        for lo, hi in _split_ranges(n_keys, split_keys, splits):
            m = torch.full((H,), pa.MASK)
            den = torch.zeros(H, dtype=acc_t)
            acc = torch.zeros(H, r, dtype=acc_t)
            for t0 in range(lo, hi, tile):
                t1 = min(t0 + tile, hi)
                s = (q @ kv[t0:t1].T * scale).float()
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                den = den * alpha.to(acc_t) + p.to(acc_t).sum(-1)
                acc = acc * alpha.to(acc_t)[:, None]
                v = kv[t0:t1, :r]
                if dtype == torch.float32:
                    acc = acc + p.to(acc_t) @ v
                else:  # the smallest part first, as the kernel's mma order
                    for part in reversed(_bf16_parts(p)):
                        acc = acc + part @ v
                m = m_new
            parts.append((m, den, acc.float().to(acc_t)))  # the workspace's fp32 acc
        m = torch.stack([pm for pm, _, _ in parts]).amax(0)
        den = torch.zeros(H, dtype=acc_t)
        acc = torch.zeros(H, r, dtype=acc_t)
        for pm, pden, pacc in parts:  # ascending split order
            f = torch.exp(pm - m).to(acc_t)
            den = den + pden * f
            acc = acc + pacc * f[:, None]
        out[b] = (acc / den[:, None]).float()
    return out[:, None].to(dtype)


def _case(B, H, r, dr, page, maxp, seq_pos, seed=0):
    """numpy inputs: distinct physical pages for each slot's used pages,
    null page 0 in every table column past its seq_pos."""
    rng = np.random.default_rng(seed)
    num_pages = B * maxp + 1
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, num_pages))
    for b, pos in enumerate(seq_pos):
        used = pos // page + 1
        table[b, :used] = phys[b * maxp:b * maxp + used]
    q_lat = rng.standard_normal((B, 1, H, r)).astype(np.float32)
    q_rope = rng.standard_normal((B, 1, H, dr)).astype(np.float32)
    ckv = rng.standard_normal((num_pages, page, r)).astype(np.float32)
    krope = rng.standard_normal((num_pages, page, dr)).astype(np.float32)
    return q_lat, q_rope, ckv, krope, table, np.asarray(seq_pos, np.int32)


def _torch_args(case, dtype):
    return [torch.from_numpy(x).to(dtype) for x in case[:4]] + \
        [torch.from_numpy(x) for x in case[4:]]


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return (got - want).abs().max().item() <= TOL
    return bool(torch.all((got - want).abs() <= BF16_ROUNDING * want.abs() + TOL))


SK = 128  # the bf16 split; the fp32 one, 256, is two of them
EDGES = [0, SK - 2, SK - 1, SK]  # slots of 1, SK-1, SK, SK+1 keys

PALLAS_CASES = [
    # (H, r, dr, page, maxp, seq_pos): heads over a CTA's 16; pages of 16 and
    # of 256 (a split ends mid-page); null-page columns past every seq_pos;
    # r of 36 (not a multiple of 8: the kernel's narrower copy)
    (4, 16, 8, 16, SK // 16 + 2, EDGES),
    (18, 32, 8, 16, (2 * SK + 40) // 16 + 1, [2 * SK - 1, 2 * SK + 40]),
    (3, 36, 4, 256, 2, [0, SK, 300]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,r,dr,page,maxp,seq_pos", PALLAS_CASES)
def test_emulator_matches_pallas(H, r, dr, page, maxp, seq_pos, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.paged_attention import mla_paged_attention_decode as jax_decode

    case = _case(len(seq_pos), H, r, dr, page, maxp, seq_pos)
    scale = (r + dr) ** -0.5
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = [jnp.asarray(x, jdt) for x in case[:4]] + [jnp.asarray(x) for x in case[4:]]
    want = jax_decode(*j, scale=scale, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = emulate(*_torch_args(case, dtype), scale)
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    assert _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,r,dr,page,maxp,seq_pos", [
    (4, 128, 512, 64, 128, 16, [0, 127, 1000, 1900]),  # DeepSeek-V3 decode shapes
    (3, 20, 40, 12, 32, 4 * SK // 32 + 3, [2 * SK - 1, 2 * SK, 4 * SK + 5]),
])
def test_emulator_matches_mla_decode_plain(B, H, r, dr, page, maxp, seq_pos, dtype):
    """The split and the combine against the CPU path's plain version, at
    widths the Pallas interpreter cannot take in time."""
    args = _torch_args(_case(B, H, r, dr, page, maxp, seq_pos, seed=1), dtype)
    scale = (128 + dr) ** -0.5
    want = pa.mla_decode_plain(*args, scale=scale)
    assert _close(emulate(*args, scale), want, dtype)
    assert torch.equal(pa.mla_paged_attention_decode(*args, scale=scale), want)  # CPU: plain


def test_emulator_is_batch_invariant():
    """A slot alone, in a batch, and behind null-page columns: the same bits."""
    args = _torch_args(_case(4, 18, 24, 8, 16, 36, [5, 300, 2 * SK, 2 * SK - 1]), torch.float32)
    full = emulate(*args, 0.2)
    wide = torch.cat([args[4], torch.zeros_like(args[4])], 1)
    wider = emulate(*args[:4], wide, args[5], 0.2)
    for b in range(4):
        alone = emulate(args[0][b:b + 1], args[1][b:b + 1], *args[2:4], args[4][b:b + 1],
                        args[5][b:b + 1], 0.2)
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
    pa.mla_paged_attention_decode.launches = 0
    yield lib
    pa.mla_paged_attention_decode.launches = 0


@pytest.mark.parametrize("dtype,entry,words", [
    (torch.float32, "mla_paged_attention_decode_f32", 2),
    (torch.bfloat16, "mla_paged_attention_decode_bf16", 1)])
@pytest.mark.parametrize("B,H,r,dr,page,maxp", [(4, 128, 512, 64, 128, 16),
                                                (1, 6, 36, 4, 16, 513),
                                                (3, 20, 24, 8, 8, 5)])
def test_route_passes_the_plan_and_a_workspace(fake_card, dtype, entry, words, B, H, r, dr,
                                               page, maxp):
    q_lat = torch.zeros(B, 1, H, r, dtype=dtype)
    q_rope = torch.zeros(B, 1, H, dr, dtype=dtype)
    # the pools one element into a larger buffer: contiguous but off a
    # 16-byte address; the kernel narrows its copies, the wrapper copies
    # nothing (they are the serving engine's whole latent cache)
    ckv = torch.zeros(2 * page * r + 1, dtype=dtype)[1:].view(2, page, r)
    krope = torch.zeros(2 * page * dr + 1, dtype=dtype)[1:].view(2, page, dr)
    table = torch.zeros(B, maxp, dtype=torch.int32)
    seq = torch.zeros(B, dtype=torch.int32)
    copies = _build.operand_copies
    out = pa.mla_paged_attention_decode(q_lat, q_rope, ckv, krope, table, seq, scale=0.5)
    (name, args), = fake_card.calls
    splits = pa.mla_decode_plan(page, maxp, dtype)[1]
    assert name == entry and out.shape == q_lat.shape and out.dtype == dtype
    assert args[:6] == tuple(t.data_ptr() for t in (q_lat, q_rope, ckv, krope, table, seq))
    assert args[8:15] == (B, H, r, dr, page, maxp, splits) and args[15] == 0.5
    assert _build.operand_copies == copies
    ws, = pa._workspaces.values()  # one partials buffer, reused by the next call
    assert args[7] == ws.data_ptr() and ws.dtype == torch.float32
    assert ws.numel() == pa.mla_workspace_floats(B, H, splits, r, dtype) == \
        B * H * splits * (words + 1 + r)
    pa.mla_paged_attention_decode(q_lat, q_rope, ckv, krope, table, seq, scale=0.5)
    assert fake_card.calls[1][1][7] == ws.data_ptr()
    assert pa.mla_paged_attention_decode.launches == 2  # two kernels, one launch a call


def test_route_copies_a_view(fake_card):
    """A view that is not contiguous reaches the kernel as one contiguous
    copy, counted apart from the launches; contiguous operands as they are."""
    pools = (torch.zeros(3, 8, 4), torch.zeros(3, 8, 2), torch.zeros(2, 2, dtype=torch.int32),
             torch.zeros(2, dtype=torch.int32))
    copies = _build.operand_copies
    out = pa.mla_paged_attention_decode(torch.zeros(2, 1, 4, 4), torch.zeros(2, 1, 4, 2),
                                        *pools, scale=1.0)
    assert _build.operand_copies == copies and out.is_contiguous()
    q_lat = torch.zeros(2, 4, 4).transpose(1, 2)[:, None]  # (2, 1, 4, 4), strided
    q_rope = torch.zeros(2, 1, 4, 4)[..., :2]  # (2, 1, 4, 2), strided
    out = pa.mla_paged_attention_decode(q_lat, q_rope, *pools, scale=1.0)
    _, args = fake_card.calls[-1]
    assert _build.operand_copies == copies + 2 and out.is_contiguous()
    assert args[0] != q_lat.data_ptr() and args[2] == pools[0].data_ptr()
    assert pa.mla_paged_attention_decode.launches == 2


def test_route_refuses_what_the_kernel_cannot_take(fake_card):
    table = torch.zeros(1, 4, dtype=torch.int32)
    seq = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="r up to 512"):
        pa.mla_paged_attention_decode(torch.zeros(1, 1, 2, 520), torch.zeros(1, 1, 2, 8),
                                      torch.zeros(2, 8, 520), torch.zeros(2, 8, 8), table, seq,
                                      scale=1.0)
    with pytest.raises(ValueError, match="r \\+ dr up to 576"):
        pa.mla_paged_attention_decode(torch.zeros(1, 1, 2, 512), torch.zeros(1, 1, 2, 72),
                                      torch.zeros(2, 8, 512), torch.zeros(2, 8, 72), table, seq,
                                      scale=1.0)
    with pytest.raises(ValueError, match="65535"):
        pa.mla_paged_attention_decode(torch.zeros(1, 1, 2, 8), torch.zeros(1, 1, 2, 4),
                                      torch.zeros(2, 8, 8), torch.zeros(2, 8, 4),
                                      torch.zeros(1, 65535 * SPLIT[torch.float32] // 8 + 1,
                                                  dtype=torch.int32),
                                      seq, scale=1.0)
    assert not fake_card.calls and pa.mla_paged_attention_decode.launches == 0
