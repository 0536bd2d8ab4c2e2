"""The PyTorch port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper takes its kernel's plain version (the tensors lie on
the CPU), which is held here against the JAX Pallas kernel in interpret
mode at 2e-5, the op-level tolerance of tests/test_backend.py.  The cases
marked ``cuda`` hold the compiled CUDA kernel against its plain version and
skip unless a card of compute capability 9.0 or more is present.
"""
import pytest

torch = pytest.importorskip("torch")

import importlib

import numpy as np

import repro_torch.kernels as tk
from repro_torch.kernels import _build
from repro_torch.kernels.batching import lead_grid
from repro_torch.kernels.bwma_attention import ATTN_TILES, attention_plain, launch_attention
from repro_torch.kernels.bwma_gemm import CTA_TILES, gemm_plain, launch_gemm
from repro_torch.kernels.bwma_layernorm import layernorm_plain, layernorm_plan
from repro_torch.kernels.bwma_softmax import softmax_plain
from repro_torch.kernels.bwma_transpose import transpose_plain
from repro_torch.kernels.paged_attention import copy_plain, decode_plain, mla_decode_plain
from repro_torch.kernels.rwma_gemm import launch_rwma, rwma_plain

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(x)


@pytest.fixture
def jax_kernel():
    """The JAX package's Pallas kernel of a module, imported only by the CPU
    parity tests, so the ``cuda`` cases also run where JAX is absent
    (``pytest --noconftest -m cuda``)."""
    pytest.importorskip("jax")

    def get(module):
        return getattr(importlib.import_module(f"repro.kernels.{module}"), module)

    return get


@pytest.fixture
def cuda_card():
    """Skip unless a Hopper-class card (capability >= 9.0) is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_counts():
    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()


GEMM_CASES = [
    # (a lead, b lead, gm, gk, gn, block): plain, head broadcast (1,) vs (h,),
    # batch x head, shared weights under a batch lead, blocks 8 and 16
    ((), (), 3, 4, 2, 16),
    ((1,), (3,), 2, 3, 2, 8),
    ((2, 1), (3,), 2, 2, 3, 16),
    ((2,), (), 3, 5, 2, 8),
]


@pytest.mark.parametrize("la,lb,gm,gk,gn,block", GEMM_CASES)
def test_gemm_plain_matches_pallas(jax_kernel, la, lb, gm, gk, gn, block):
    a = _rand(0, *la, gm, gk, block, block)
    b = _rand(1, *lb, gk, gn, block, block, scale=0.1)
    want = np.asarray(jax_kernel("bwma_gemm")(a, b, interpret=True))
    got = tk.bwma_gemm(_t(a), _t(b))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tk.launch_counts()["bwma_gemm"] == 0  # no launch on the CPU


@pytest.mark.parametrize("la,gm,gk,gn,block", [((), 2, 3, 4, 16), ((2,), 3, 2, 5, 8),
                                                ((2, 2), 1, 4, 2, 8)])
def test_fused_ffn_plain_matches_pallas(jax_kernel, la, gm, gk, gn, block):
    a = _rand(2, *la, gm, gk, block, block)
    w = _rand(3, gk, gn, block, block, scale=0.2)
    bias = _rand(4, gn, block, scale=0.5)
    want = np.asarray(jax_kernel("bwma_fused_ffn")(a, w, bias, interpret=True))
    got = tk.bwma_fused_ffn(_t(a), _t(w), _t(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tk.launch_counts()["bwma_fused_ffn"] == 0


@pytest.mark.parametrize("lead,gm,gn,block,n_logical", [
    ((), 3, 5, 16, 72),   # ragged: the last column block is partly padding
    ((2,), 2, 3, 8, 17),
    ((2, 3), 2, 2, 16, 32),
    ((), 4, 6, 8, 48),
])
def test_layernorm_plain_matches_pallas(jax_kernel, lead, gm, gn, block, n_logical):
    x = _rand(5, *lead, gm, gn, block, block, scale=3.0) + 1.0
    gamma = _rand(6, gn, block)
    beta = _rand(7, gn, block)
    want = np.asarray(jax_kernel("bwma_layernorm")(x, gamma, beta, n_logical, interpret=True))
    got = tk.bwma_layernorm(_t(x), _t(gamma), _t(beta), n_logical)
    # padded columns are written as exactly 0 by both: compare every element
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tk.launch_counts()["bwma_layernorm"] == 0


ATTN_CASES = [
    # (q lead, kv lead, gs, gd, block, s_logical)
    ((2, 3), (2, 3), 3, 2, 16, 45),  # ragged keys, batch x heads
    ((3,), (3,), 4, 2, 8, 30),
    ((3,), (1,), 2, 3, 8, 16),  # K/V broadcast over the query heads
    ((), (), 2, 4, 16, 32),
    # query tiles of the CUDA kernel that span several query blocks (8 of 16)
    ((2,), (2,), 8, 4, 16, 128),
    # s_logical ending mid key tile (keys 64..127), and skipping whole key
    # tiles (keys 100..255 of four 64-key tiles)
    ((2,), (2,), 16, 2, 8, 70),
    ((1,), (1,), 16, 4, 16, 100),
    # K/V broadcast over the query heads under a batch lead, several key tiles
    ((2, 3), (2, 1), 8, 4, 16, 120),
    # block 128 (d_head 64 padded to 128) at batch 4 and 1, and a head of 256
    ((4, 2), (4, 2), 4, 1, 128, 512),
    ((1, 2), (1, 2), 4, 1, 128, 500),
    ((2,), (2,), 2, 4, 64, 100),
]


@pytest.mark.parametrize("lq,lkv,gs,gd,block,s_logical", ATTN_CASES)
def test_attention_plain_matches_pallas(jax_kernel, lq, lkv, gs, gd, block, s_logical):
    q = _rand(8, *lq, gs, gd, block, block)
    k = _rand(9, *lkv, gs, gd, block, block)
    v = _rand(10, *lkv, gs, gd, block, block)
    want = np.asarray(jax_kernel("bwma_attention")(q, k, v, scale=0.3, s_logical=s_logical,
                                                   interpret=True))
    got = tk.bwma_attention(_t(q), _t(k), _t(v), scale=0.3, s_logical=s_logical).numpy()
    assert got.shape == want.shape
    # padded query rows are garbage by design: compare the logical rows
    rows = (np.arange(gs * block).reshape(gs, 1, block, 1) < s_logical)
    np.testing.assert_allclose(np.where(rows, got, 0), np.where(rows, want, 0), **TOL)
    assert tk.launch_counts()["bwma_attention"] == 0


def test_lead_grid_strides_are_zero_where_an_operand_broadcasts():
    a = torch.zeros(2, 1, 3, 4, 8, 8)  # activation with a broadcasting head axis
    w = torch.zeros(5, 4, 2, 8, 8)  # per-head weights
    g = lead_grid((a, w), (4, 4))
    assert g.shape == (2, 5) and g.dims == (2, 5) and g.size == 10
    assert g.strides == ((a.stride(0), 0), (0, w.stride(0)))
    shared = lead_grid((torch.zeros(3, 2, 2, 8, 8), torch.zeros(2, 2, 8, 8)), (4, 4))
    assert shared.dims == (1, 3) and shared.strides[1] == (0, 0)  # weights never copied
    assert lead_grid((torch.zeros(2, 2, 8, 8),), (4,)).dims == (1, 1)
    with pytest.raises(ValueError, match="leading"):
        lead_grid((torch.zeros(2, 2, 2, 1, 1, 8, 8),), (4,))
    with pytest.raises(ValueError, match="contiguous"):
        lead_grid((torch.zeros(2, 1, 1, 8, 8).transpose(-1, -2),), (4,))


def test_wrappers_check_their_operands():
    a = torch.zeros(2, 2, 16, 16)
    with pytest.raises(TypeError, match="fp32"):
        tk.bwma_gemm(a.double(), a.double())
    with pytest.raises(ValueError, match="block dim"):
        tk.bwma_gemm(torch.zeros(1, 1, 12, 12), torch.zeros(1, 1, 12, 12))
    with pytest.raises(ValueError, match="inner blocks"):
        tk.bwma_gemm(torch.zeros(1, 2, 16, 16), torch.zeros(3, 1, 16, 16))
    with pytest.raises(ValueError, match="bias"):
        tk.bwma_fused_ffn(a, a, torch.zeros(3, 16))
    with pytest.raises(ValueError, match="n_logical"):
        tk.bwma_layernorm(a, torch.zeros(2, 16), torch.zeros(2, 16), 33)
    with pytest.raises(ValueError, match="s_logical"):
        tk.bwma_attention(a, a, a, scale=1.0, s_logical=40)
    with pytest.raises(ValueError, match="contiguous"):
        tk.bwma_layernorm(a.transpose(-1, -2), torch.zeros(2, 16), torch.zeros(2, 16), 16)
    assert tk.launch_counts() == dict.fromkeys(tk.launch_counts(), 0)


def test_build_finds_all_sources_and_raises_without_nvcc(monkeypatch, tmp_path):
    names = {p.name for p in _build.sources()}
    assert {"bwma_gemm.cu", "bwma_layernorm.cu", "bwma_attention.cu", "paged_attention.cu",
            "bwma_softmax.cu", "bwma_transpose.cu"} <= names
    assert len(_build._source_key()) == 16
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


# -- on the card: the compiled kernel against its plain version -------------

@pytest.mark.cuda
@pytest.mark.parametrize("la,lb,gm,gk,gn,block", GEMM_CASES)
def test_cuda_gemm_matches_plain(cuda_card, la, lb, gm, gk, gn, block):
    a = _t(_rand(0, *la, gm, gk, block, block)).to(cuda_card)
    b = _t(_rand(1, *lb, gk, gn, block, block, scale=0.1)).to(cuda_card)
    bias = _t(_rand(2, gn, block)).to(cuda_card)
    torch.testing.assert_close(tk.bwma_gemm(a, b), gemm_plain(a, b), **TOL)
    torch.testing.assert_close(tk.bwma_fused_ffn(a, b, bias), gemm_plain(a, b, bias), **TOL)
    assert tk.launch_counts()["bwma_gemm"] == 1 and tk.launch_counts()["bwma_fused_ffn"] == 1


GEMM_EDGE_CASES = [
    # (a lead, b lead, gm, gk, gn, bm, bk, bn): gm and gn not multiples of the
    # CTA tile's blocks, K = 3072, blocks 8..128 with bm != bn, and the
    # per-head product (batch x 12 heads, N = 64)
    ((), (), 9, 3, 5, 16, 16, 16),
    ((2,), (), 17, 2, 9, 8, 8, 8),
    ((), (), 4, 192, 4, 16, 16, 16),
    ((), (), 1, 24, 2, 128, 128, 128),
    ((2,), (), 3, 2, 5, 128, 64, 32),
    ((), (3,), 2, 1, 2, 32, 128, 128),
    ((2, 1), (12,), 8, 12, 4, 16, 16, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("la,lb,gm,gk,gn,bm,bk,bn", GEMM_EDGE_CASES)
def test_cuda_gemm_edges_match_plain(cuda_card, la, lb, gm, gk, gn, bm, bk, bn):
    a = _t(_rand(0, *la, gm, gk, bm, bk)).to(cuda_card)
    b = _t(_rand(1, *lb, gk, gn, bk, bn, scale=0.1)).to(cuda_card)
    bias = _t(_rand(2, gn, bn)).to(cuda_card)
    torch.testing.assert_close(tk.bwma_gemm(a, b), gemm_plain(a, b), **TOL)
    torch.testing.assert_close(tk.bwma_fused_ffn(a, b, bias), gemm_plain(a, b, bias), **TOL)
    assert tk.launch_counts()["bwma_gemm"] == 1 and tk.launch_counts()["bwma_fused_ffn"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("tile", list(CTA_TILES))
def test_cuda_every_cta_tile_matches_plain(cuda_card, tile):
    """Each CTA tile the loop instantiates, forced on a product whose rows
    and columns end part-way into its last tile, in both arrangements."""
    cm, cn = tile
    gm, gn = 2 * cm // 16 + 1, cn // 16 + 1
    a = _t(_rand(3, 2, gm, 5, 16, 16)).to(cuda_card)
    b = _t(_rand(4, 5, gn, 16, 16, scale=0.1)).to(cuda_card)
    bias = _t(_rand(5, gn, 16)).to(cuda_card)
    torch.testing.assert_close(launch_gemm("bwma_gemm", a, b, None, tile), gemm_plain(a, b),
                               **TOL)
    torch.testing.assert_close(launch_gemm("bwma_fused_ffn", a, b, bias, tile),
                               gemm_plain(a, b, bias), **TOL)
    x = _t(_rand(6, 2 * cm + 8, 40)).to(cuda_card)
    w = _t(_rand(7, 40, cn + 8, scale=0.1)).to(cuda_card)
    torch.testing.assert_close(launch_rwma(x, w, 8, 8, 8, tile),
                               rwma_plain(x, w, bm=8, bk=8, bn=8), **TOL)


@pytest.mark.cuda
def test_cuda_gemms_are_bit_identical_run_to_run(cuda_card):
    """No split-K and no atomics: each output is summed by one thread in k
    order, so two launches on the same inputs give the same bits."""
    a = _t(_rand(8, 2, 5, 192, 16, 16)).to(cuda_card)
    b = _t(_rand(9, 192, 7, 16, 16, scale=0.1)).to(cuda_card)
    bias = _t(_rand(10, 7, 16)).to(cuda_card)
    assert torch.equal(tk.bwma_gemm(a, b), tk.bwma_gemm(a, b))
    assert torch.equal(tk.bwma_fused_ffn(a, b, bias), tk.bwma_fused_ffn(a, b, bias))
    x = _t(_rand(11, 24, 3072)).to(cuda_card)
    w = _t(_rand(12, 3072, 1024, scale=0.1)).to(cuda_card)
    assert torch.equal(tk.rwma_gemm(x, w, bm=24, bk=24, bn=8), tk.rwma_gemm(x, w, bm=24, bk=24,
                                                                           bn=8))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
def test_cuda_layernorm_matches_plain(cuda_card, block):
    x = _t(_rand(5, 2, 2, 3, block, block, scale=3.0)).to(cuda_card)
    gamma, beta = (_t(_rand(s, 3, block)).to(cuda_card) for s in (6, 7))
    n = 3 * block - 5
    torch.testing.assert_close(tk.bwma_layernorm(x, gamma, beta, n),
                               layernorm_plain(x, gamma, beta, n), **TOL)
    assert tk.launch_counts()["bwma_layernorm"] == 1


BF16_ROUNDING = 2.0 ** -7


def _within_one_bf16_rounding(got, want):
    """Kernel and plain version both compute in fp32 and round once to bf16,
    so they may differ by one rounding of the result: 2^-7 of its magnitude
    (plus 1e-6 for the fp32 sums' own order)."""
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= BF16_ROUNDING * want.float().abs() + 1e-6), err.max().item()


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,param_dtype", [(F32, F32), (BF16, F32), (BF16, BF16),
                                                 (F32, BF16)])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
def test_cuda_layernorm_types_match_plain(cuda_card, block, x_dtype, param_dtype):
    """x and gamma/beta each fp32 or bf16, at every block, a ragged width
    and broadcast leads (batch x heads, and a head axis of 1): fp32 within
    2e-5, bf16 within one bf16 rounding, one launch per call."""
    gamma, beta = (_t(_rand(s, 3, block)).to(cuda_card, param_dtype) for s in (6, 7))
    n = 3 * block - 5
    for seed, lead in ((5, (2, 3)), (6, (3, 1))):
        x = _t(_rand(seed, *lead, 2, 3, block, block, scale=3.0)).to(cuda_card, x_dtype)
        got = tk.bwma_layernorm(x, gamma, beta, n)
        want = layernorm_plain(x, gamma, beta, n)
        assert got.dtype == x_dtype
        if x_dtype == F32:
            torch.testing.assert_close(got, want, **TOL)
        else:
            _within_one_bf16_rounding(got, want)
    assert tk.launch_counts()["bwma_layernorm"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,width", [(F32, 2048), (F32, 4096), (BF16, 4096), (BF16, 8192),
                                         (F32, 768), (BF16, 768)])
def test_cuda_layernorm_wide_rows_match_plain(cuda_card, dtype, width):
    """The widest rows of the register path (2048 fp32, 4096 bf16) and rows
    twice as wide, which take the looped path, beside BERT-base's 768."""
    block = 128
    gn = width // block
    x = _t(_rand(11, 2, 2, gn, block, block, scale=2.0)).to(cuda_card, dtype)
    gamma, beta = (_t(_rand(s, gn, block)).to(cuda_card) for s in (12, 13))
    n = width - 37
    _, looped = layernorm_plan(width, dtype)
    assert looped == (width > 16 * 32 * 16 // x.element_size())
    got = tk.bwma_layernorm(x, gamma, beta, n)
    want = layernorm_plain(x, gamma, beta, n)
    if dtype == F32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        _within_one_bf16_rounding(got, want)
    assert tk.launch_counts()["bwma_layernorm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lkv,gs,gd,block,s_logical",
                         ATTN_CASES[:4] + [((2,), (2,), 4, 1, 128, 500)])
def test_cuda_attention_bf16_matches_plain(cuda_card, lq, lkv, gs, gd, block, s_logical):
    q = _t(_rand(8, *lq, gs, gd, block, block)).to(cuda_card, BF16)
    k = _t(_rand(9, *lkv, gs, gd, block, block)).to(cuda_card, BF16)
    v = _t(_rand(10, *lkv, gs, gd, block, block)).to(cuda_card, BF16)
    got = tk.bwma_attention(q, k, v, scale=0.3, s_logical=s_logical)
    want = attention_plain(q, k, v, scale=0.3, s_logical=s_logical)
    rows = torch.arange(gs * block, device=cuda_card).reshape(gs, 1, block, 1) < s_logical
    _within_one_bf16_rounding(torch.where(rows, got, 0.0), torch.where(rows, want, 0.0))
    assert tk.launch_counts()["bwma_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [torch.float64, torch.float16])
def test_cuda_layernorm_and_attention_refuse_other_types(cuda_card, bad):
    """No fallback on the card: another type raises before any launch."""
    x = torch.zeros(2, 2, 16, 16, device=cuda_card, dtype=bad)
    g = torch.ones(2, 16, device=cuda_card)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tk.bwma_layernorm(x, g, g, 32)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tk.bwma_attention(x, x, x, scale=1.0, s_logical=32)
    assert tk.launch_counts() == dict.fromkeys(tk.launch_counts(), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lkv,gs,gd,block,s_logical",
                         ATTN_CASES + [((2,), (2,), 4, 1, 128, 500)])
def test_cuda_attention_matches_plain(cuda_card, lq, lkv, gs, gd, block, s_logical):
    q = _t(_rand(8, *lq, gs, gd, block, block)).to(cuda_card)
    k = _t(_rand(9, *lkv, gs, gd, block, block)).to(cuda_card)
    v = _t(_rand(10, *lkv, gs, gd, block, block)).to(cuda_card)
    got = tk.bwma_attention(q, k, v, scale=0.3, s_logical=s_logical)
    want = attention_plain(q, k, v, scale=0.3, s_logical=s_logical)
    rows = torch.arange(gs * block, device=cuda_card).reshape(gs, 1, block, 1) < s_logical
    torch.testing.assert_close(torch.where(rows, got, 0.0), torch.where(rows, want, 0.0), **TOL)
    assert tk.launch_counts()["bwma_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dp", list(ATTN_TILES))
def test_cuda_every_attention_tile_matches_plain(cuda_card, dp):
    """The CTA tile of each padded width the kernel instantiates, on a call
    whose query rows end part-way into the last tile and whose keys end
    part-way into a key tile."""
    bq, bkv = ATTN_TILES[dp]
    block = 16
    gd = dp // block - 1  # width dp - 16: the last 16 staged columns zero-filled
    gs = (2 * bq + bkv) // block + 1
    s_logical = gs * block - bkv // 2 - 3
    q = _t(_rand(8, 2, 3, gs, gd, block, block)).to(cuda_card)
    k = _t(_rand(9, 2, 1, gs, gd, block, block)).to(cuda_card)
    v = _t(_rand(10, 2, 1, gs, gd, block, block)).to(cuda_card)
    got = launch_attention(q, k, v, scale=0.2, s_logical=s_logical)
    want = attention_plain(q, k, v, scale=0.2, s_logical=s_logical)
    rows = torch.arange(gs * block, device=cuda_card).reshape(gs, 1, block, 1) < s_logical
    torch.testing.assert_close(torch.where(rows, got, 0.0), torch.where(rows, want, 0.0), **TOL)


@pytest.mark.cuda
def test_cuda_attention_is_bit_identical_run_to_run(cuda_card):
    """No split over keys and no atomics: each output is summed by one
    thread in key order, so two launches on the same inputs give the same
    bits (BERT-base shapes, blocks 16 and 128)."""
    for gd, block in ((4, 16), (1, 128)):
        gs = 512 // block
        q, k, v = (_t(_rand(s, 2, 12, gs, gd, block, block)).to(cuda_card) for s in (8, 9, 10))
        assert torch.equal(tk.bwma_attention(q, k, v, scale=0.125, s_logical=500),
                           tk.bwma_attention(q, k, v, scale=0.125, s_logical=500))
    assert tk.launch_counts()["bwma_attention"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,block", [(64, 48, 32, 8), (96, 64, 48, 16), (64, 96, 128, 32),
                                         (128, 64, 192, 64), (256, 384, 256, 128),
                                         (48, 72, 96, 24), (27, 45, 18, 9),
                                         (192, 384, 576, 192),
                                         # M = 16 against K and N in the
                                         # thousands; N ending mid-tile
                                         (16, 3072, 2048, 16), (40, 64, 200, 8)])
def test_cuda_rwma_matches_plain(cuda_card, M, K, N, block):
    a = _t(_rand(11, M, K)).to(cuda_card)
    b = _t(_rand(12, K, N, scale=0.1)).to(cuda_card)
    got = tk.rwma_gemm(a, b, bm=block, bk=block, bn=block)
    torch.testing.assert_close(got, rwma_plain(a, b, bm=block, bk=block, bn=block), **TOL)
    assert tk.launch_counts()["rwma_gemm"] == 1


def _paged_case(dev, B, H, hkv, dh, page, maxp, seq_pos, dtype):
    rng = np.random.default_rng(13)
    num_pages = B * maxp + 1
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, num_pages))
    for b, pos in enumerate(seq_pos):
        used = pos // page + 1
        table[b, :used] = phys[b * maxp:b * maxp + used]  # the rest: null page
    q, k, v = (_t(_rand(s, *shape)).to(dev, dtype) for s, shape in (
        (14, (B, 1, H, dh)), (15, (num_pages, page, hkv, dh)), (16, (num_pages, page, hkv, dh))))
    return q, k, v, _t(table).to(dev), torch.tensor(seq_pos, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,hkv,dh,page,maxp,seq_pos", [
    (2, 4, 2, 16, 8, 4, [0, 31]),
    (3, 6, 6, 64, 16, 5, [5, 16, 79]),
    (4, 36, 4, 128, 128, 16, [0, 127, 1000, 1900]),  # starcoder2-7b decode shapes
    # pages of 16; slots ending at the split edges (127, 128, 255, 256 with
    # 128-key splits) and one of three splits
    (5, 18, 2, 128, 16, 24, [126, 127, 128, 255, 300]),
    (1, 36, 4, 128, 128, 64, [8191]),  # one slot of 8192 keys
    (3, 16, 2, 64, 32, 12, [0, 129, 383]),  # G 8 at dh 64
])
def test_cuda_paged_decode_matches_plain(cuda_card, dtype, B, H, hkv, dh, page, maxp, seq_pos):
    """fp32 within 1e-6 (the JAX suite's TOL); bf16 within one bf16 rounding
    of the plain output (both compute in fp32 and round once; the kernel's
    split and combine reassociate the fp32 sums)."""
    args = _paged_case(cuda_card, B, H, hkv, dh, page, maxp, seq_pos, dtype)
    got, want = tk.paged_attention_decode(*args).float(), decode_plain(*args).float()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-6
    else:
        assert torch.all((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6)
    assert tk.launch_counts()["paged_attention_decode"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_is_batch_invariant(cuda_card, dtype):
    """The split is fixed in keys: each slot of a 4-slot call gives the same
    bits as the slot run alone (B 1) and behind maxp doubled by null-page
    columns (starcoder2-7b decode shapes)."""
    q, k, v, table, seq = _paged_case(cuda_card, 4, 36, 4, 128, 128, 16, [0, 127, 1000, 1900],
                                      dtype)
    full = tk.paged_attention_decode(q, k, v, table, seq)
    wide = tk.paged_attention_decode(q, k, v, torch.cat([table, torch.zeros_like(table)], 1),
                                     seq)
    for b in range(4):
        alone = tk.paged_attention_decode(q[b:b + 1], k, v, table[b:b + 1], seq[b:b + 1])
        assert torch.equal(alone[0], full[b]) and torch.equal(wide[b], full[b])
    assert tk.launch_counts()["paged_attention_decode"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_is_bit_identical_run_to_run(cuda_card, dtype):
    """No atomics; the combine merges the splits in ascending order: two
    launches on the same inputs give the same bits."""
    args = _paged_case(cuda_card, 5, 18, 2, 128, 16, 24, [126, 127, 128, 255, 300], dtype)
    assert torch.equal(tk.paged_attention_decode(*args), tk.paged_attention_decode(*args))
    assert tk.launch_counts()["paged_attention_decode"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_cuda_paged_copy_bit_exact(cuda_card, dtype):
    pool = (_t(_rand(17, 4, 9, 8, 2, 6)) * 50).to(cuda_card, dtype)
    want = pool.clone()
    ptr = pool.data_ptr()
    assert tk.paged_copy(pool, 2, 7) is pool and pool.data_ptr() == ptr
    copy_plain(want, 2, 7)
    assert torch.equal(pool, want)
    tk.paged_copy(pool, 3, 3)
    assert torch.equal(pool, want) and tk.launch_counts()["paged_copy"] == 2


def _mla_case(dev, B, H, r, dr, page, maxp, seq_pos, dtype):
    rng = np.random.default_rng(18)
    num_pages = B * maxp + 1
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, num_pages))
    for b, pos in enumerate(seq_pos):
        used = pos // page + 1
        table[b, :used] = phys[b * maxp:b * maxp + used]  # the rest: null page
    q_lat, q_rope, ckv, krope = (_t(_rand(s, *shape)).to(dev, dtype) for s, shape in (
        (19, (B, 1, H, r)), (20, (B, 1, H, dr)), (21, (num_pages, page, r)),
        (22, (num_pages, page, dr))))
    return (q_lat, q_rope, ckv, krope, _t(table).to(dev),
            torch.tensor(seq_pos, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,r,dr,page,maxp,seq_pos", [
    (2, 4, 16, 8, 8, 4, [0, 31]),
    (3, 12, 24, 8, 16, 5, [5, 16, 79]),  # a partial last group of heads
    (4, 128, 512, 64, 128, 16, [0, 127, 1000, 1900]),  # DeepSeek-V3 decode shapes
])
def test_cuda_mla_decode_matches_plain(cuda_card, dtype, B, H, r, dr, page, maxp, seq_pos):
    """fp32 within 1e-6 (the JAX suite's paged TOL); bf16 within one bf16
    rounding of the plain output (both compute in fp32 and round once)."""
    args = _mla_case(cuda_card, B, H, r, dr, page, maxp, seq_pos, dtype)
    scale = (128 + dr) ** -0.5
    got = tk.mla_paged_attention_decode(*args, scale=scale).float()
    want = mla_decode_plain(*args, scale=scale).float()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-6
    else:
        assert torch.all((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6)
    assert tk.launch_counts()["mla_paged_attention_decode"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,gm,gn,bm,bn,n_logical", [
    ((), 3, 5, 16, 16, 70), ((2,), 2, 3, 8, 8, 24), ((4, 12), 32, 32, 16, 16, 512),
    ((4, 12), 4, 4, 128, 128, 512), ((2, 3), 1, 4, 128, 128, 500), ((1,), 2, 9, 64, 64, 555),
    ((2,), 3, 4, 6, 16, 60),  # bm 6: a CTA of 4 rows straddles two block-rows
    ((2,), 1, 17, 128, 128, 2176), ((1,), 2, 17, 128, 128, 2100),  # looped in fp32
    ((1,), 1, 33, 128, 128, 4224), ((2,), 1, 33, 128, 128, 4219),  # looped in both types
    ((2,), 2, 3, 16, 16, 1),  # one live column
    ((), 2, 4, 16, 16, 62),  # the row ends inside its last 16-byte vector
])
def test_cuda_softmax_matches_plain(cuda_card, dtype, lead, gm, gn, bm, bn, n_logical):
    """fp32 within 2e-5 (the op-level tolerance); bf16 within one bf16
    rounding (both compute in fp32 and round once)."""
    x = (_t(_rand(23, *lead, gm, gn, bm, bn)) * 3).to(cuda_card, dtype)
    got, want = tk.bwma_softmax(x, n_logical), softmax_plain(x, n_logical)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert torch.all((got.float() - want.float()).abs() <= 2.0 ** -7 * want.float().abs()
                         + 1e-6)
    col = torch.arange(gn * bn, device=cuda_card).reshape(gn, 1, bn)
    assert torch.all(torch.where(col >= n_logical, got, 0) == 0)
    assert tk.launch_counts()["bwma_softmax"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,gm,gn,block,n_logical", [
    ((4, 12), 32, 32, 16, 512), ((4, 12), 4, 4, 128, 500), ((2,), 1, 33, 128, 4219)])
def test_cuda_softmax_is_bit_identical_run_to_run(cuda_card, dtype, lead, gm, gn, block,
                                                  n_logical):
    """A fixed reduction order and no atomics: the same bits every call, on
    the register path and the looped one."""
    x = (_t(_rand(29, *lead, gm, gn, block, block)) * 3).to(cuda_card, dtype)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    first = tk.bwma_softmax(x, n_logical).view(bits)
    for _ in range(3):
        assert torch.equal(tk.bwma_softmax(x, n_logical).view(bits), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8, torch.float64,
                                   torch.complex128])
@pytest.mark.parametrize("lead,gm,gn,bm,bn", [
    ((), 3, 5, 16, 16), ((2, 3), 4, 1, 128, 128), ((4, 12), 32, 4, 16, 16), ((2,), 3, 2, 8, 32),
    ((2,), 3, 2, 64, 64),  # block 64: one whole block a CTA in fp32, two in bf16
    ((2,), 3, 2, 24, 40), ((3,), 2, 5, 1, 7),  # rows of 96/160 and 4/28 bytes in fp32
    ((7,), 3, 3, 8, 8),  # 63 blocks: not a multiple of a CTA's 64 (fp32) or 128 (bf16)
])
def test_cuda_transpose_bit_exact(cuda_card, dtype, lead, gm, gn, bm, bn):
    x = (_t(_rand(24, *lead, gm, gn, bm, bn)) * 50).to(cuda_card, dtype)
    got = tk.bwma_transpose(x)
    assert tuple(got.shape) == (*lead, gn, gm, bn, bm)
    assert torch.equal(got, transpose_plain(x))
    assert tk.launch_counts()["bwma_transpose"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bits", [(torch.float32, torch.int32), (torch.bfloat16, torch.int16),
                                        (torch.float64, torch.int64)])
@pytest.mark.parametrize("block", [16, 128])
def test_cuda_transpose_moves_nan_payloads(cuda_card, dtype, bits, block):
    """Random bit patterns (NaNs with every payload among them) move bit
    for bit: the kernel moves words, not values."""
    n = 2 * 3 * 2 * block * block
    raw = torch.from_numpy(np.random.default_rng(25).integers(0, 256, n * dtype.itemsize,
                                                              dtype=np.uint8))
    x = raw.view(dtype).reshape(2, 3, 2, block, block).to(cuda_card)
    got = tk.bwma_transpose(x)
    assert torch.equal(got.view(bits), transpose_plain(x).view(bits))


@pytest.mark.parametrize("plain", ["gemm", "attention", "rwma", "paged_decode", "mla_decode"])
def test_plain_versions_run_without_tf32(monkeypatch, plain):
    """The plain versions are fp32 oracles: they turn TF32 off around their
    products whatever the caller set, and restore the caller's setting."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    for name in ("matmul", "einsum"):
        real = getattr(torch, name)

        def spy(*args, _real=real, **kw):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return _real(*args, **kw)

        monkeypatch.setattr(torch, name, spy)
    x = torch.ones(1, 2, 8, 8)
    if plain == "gemm":
        gemm_plain(x, torch.ones(2, 1, 8, 8))
    elif plain == "attention":
        attention_plain(x, x, x, scale=1.0, s_logical=8)
    elif plain == "rwma":
        rwma_plain(torch.ones(16, 16), torch.ones(16, 8), bm=8, bk=8, bn=8)
    elif plain == "paged_decode":
        pool = torch.ones(3, 8, 1, 8)
        decode_plain(torch.ones(2, 1, 2, 8), pool, pool, torch.ones(2, 2, dtype=torch.int32),
                     torch.ones(2, dtype=torch.int32))
    else:
        mla_decode_plain(torch.ones(2, 1, 2, 8), torch.ones(2, 1, 2, 4), torch.ones(3, 8, 8),
                         torch.ones(3, 8, 4), torch.ones(2, 2, dtype=torch.int32),
                         torch.ones(2, dtype=torch.int32), scale=1.0)
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
