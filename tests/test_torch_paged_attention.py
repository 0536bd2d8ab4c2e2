"""The port's serving kernels against the JAX Pallas kernels, on the CPU.

On the CPU each wrapper takes its kernel's plain version (the tensors lie on
the CPU).  Held here against the JAX package's kernels in interpret mode:
the paged decode within 1e-6 (the JAX suite's ``TOL``,
tests/test_paged_kernels.py -- online-softmax reassociation), also against
the gather oracles of both packages; the page copy bit-exact and in place;
the row-major GEMM within 2e-5 (the op-level tolerance of
tests/test_backend.py).  The compiled CUDA kernels are held against these
plain versions on the card by the ``cuda`` cases of test_torch_kernels.py.
All inputs come from a numpy seed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import repro_torch.kernels as tk
from repro.kernels.paged_attention import paged_attention_decode as jax_paged_decode
from repro.kernels.paged_attention import paged_copy as jax_paged_copy
from repro.kernels.rwma_gemm import rwma_gemm as jax_rwma_gemm
from repro.models.attention import paged_gather_attend as jax_gather_attend
from repro_torch.kernels.paged_attention import (
    copy_plain,
    decode_plain,
    paged_attention_decode,
    paged_copy,
)
from repro_torch.kernels.rwma_gemm import rwma_gemm, rwma_plain
from repro_torch.models.attention import paged_gather_attend

PAGE = 8
MAXP = 4
TOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_counts():
    tk.reset_launch_counts()
    yield
    assert all(n == 0 for n in tk.launch_counts().values()), "a kernel launched on the CPU"
    tk.reset_launch_counts()


def _layout(rng, B, maxp, used_pages, hkv, dh):
    """A paged layout: per-slot table rows mapping ``used_pages`` distinct
    physical pages (page 0 is the null page, never mapped; unused entries
    point at it), plus random K/V pools."""
    num_pages = B * maxp + 1
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, num_pages))
    for b in range(B):
        table[b, :used_pages] = phys[b * used_pages:(b + 1) * used_pages]
    k = rng.standard_normal((num_pages, PAGE, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((num_pages, PAGE, hkv, dh)).astype(np.float32)
    return table, k, v


def _edge_positions(used_pages):
    """seq_pos edges within the last used page: its first slot, an interior
    partial fill, and the fully written page."""
    last = (used_pages - 1) * PAGE
    return sorted({0, last, last + PAGE // 2, used_pages * PAGE - 1})


def _both(q, k, v, table, seq_pos):
    """(port, JAX kernel, JAX oracle, port oracle) outputs as numpy."""
    tq, tkp, tvp, tt, ts = (torch.from_numpy(x) for x in (q, k, v, table, seq_pos))
    port = paged_attention_decode(tq, tkp, tvp, tt, ts).numpy()
    jq, jk, jv, jt, js = (jnp.asarray(x) for x in (q, k, v, table, seq_pos))
    jax_out = np.asarray(jax_paged_decode(jq, jk, jv, jt, js, interpret=True))
    jax_ref = np.asarray(jax_gather_attend(jq, jk, jv, jt, js))
    port_ref = paged_gather_attend(tq, tkp, tvp, tt, ts).numpy()
    return port, jax_out, jax_ref, port_ref


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("used_pages", [1, 2, 4])
def test_paged_decode_plain_matches_pallas(used_pages, groups):
    rng = np.random.default_rng(used_pages * 10 + groups)
    B, H, dh = 2, 4, 16
    table, k, v = _layout(rng, B, MAXP, used_pages, H // groups, dh)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    for pos in _edge_positions(used_pages):
        seq_pos = np.full((B,), pos, np.int32)
        port, jax_out, jax_ref, port_ref = _both(q, k, v, table, seq_pos)
        assert port.shape == jax_out.shape and port.dtype == jax_out.dtype
        for other in (jax_out, jax_ref, port_ref):
            err = float(np.abs(port - other).max())
            assert err <= TOL, (used_pages, groups, pos, err)


def test_paged_decode_ragged_positions():
    """Slots at different fill levels in one call: each row masks by its own
    seq_pos, and null pages in unused table entries stay masked."""
    rng = np.random.default_rng(3)
    B, H, dh = 3, 6, 16
    table, k, v = _layout(rng, B, MAXP, MAXP, 2, dh)
    table[0, 1:] = 0  # slot 0 maps one page; its tail entries hit the null page
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    seq_pos = np.array([0, PAGE - 1, MAXP * PAGE - 1], np.int32)
    port, jax_out, jax_ref, port_ref = _both(q, k, v, table, seq_pos)
    for other in (jax_out, jax_ref, port_ref):
        assert float(np.abs(port - other).max()) <= TOL


def test_paged_decode_bf16_pools_match_fp32_math():
    """bf16 pools: the plain version computes in fp32 and rounds once to bf16
    at the end, so it is within one bf16 rounding of the fp32 computation on
    the same (bf16-valued) inputs."""
    rng = np.random.default_rng(5)
    B, H, dh = 2, 4, 16
    table, k, v = _layout(rng, B, MAXP, 3, 2, dh)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    seq_pos = np.array([5, 3 * PAGE - 2], np.int32)
    tq, tkp, tvp = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    tt, ts = torch.from_numpy(table), torch.from_numpy(seq_pos)
    out = paged_attention_decode(tq, tkp, tvp, tt, ts)
    assert out.dtype == torch.bfloat16
    want = decode_plain(tq.float(), tkp.float(), tvp.float(), tt, ts)
    assert torch.all((out.float() - want).abs() <= 2.0 ** -8 * want.abs() + 1e-6)


def test_paged_decode_rejects_bad_operands():
    q = torch.zeros(2, 1, 4, 16)
    pool = torch.zeros(5, PAGE, 2, 16)
    table = torch.zeros(2, MAXP, dtype=torch.int32)
    seq = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        paged_attention_decode(q, pool, pool, table.long(), seq)
    with pytest.raises(TypeError, match="share"):
        paged_attention_decode(q, pool.double(), pool.double(), table, seq)
    with pytest.raises(ValueError, match="does not fit"):
        paged_attention_decode(torch.zeros(2, 1, 3, 16), pool, pool, table, seq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_paged_copy_bit_exact_and_in_place(dtype):
    """The COW copy is pure data movement: dst page becomes src page bit for
    bit in every layer, every other page untouched, the pool's storage the
    same tensor (no new pool), and JAX's Pallas copy agrees."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((3, 5, PAGE, 2, 6)).astype(np.float32)
    pool = torch.from_numpy(base * 100).to(dtype)
    before = pool.clone()
    ptr = pool.data_ptr()
    out = paged_copy(pool, 1, 3)
    assert out is pool and pool.data_ptr() == ptr and pool.dtype == dtype
    expect = before.clone()
    expect[:, 3] = before[:, 1]
    assert torch.equal(pool, expect)
    if dtype == torch.float32:
        jax_out = np.asarray(jax_paged_copy(jnp.asarray(before.numpy()), 1, 3, interpret=True))
        np.testing.assert_array_equal(pool.numpy(), jax_out)


def test_paged_copy_same_page_and_bad_ids():
    pool = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 4, PAGE, 3)))
    before = pool.clone()
    copy_plain(pool, 2, 2)
    assert torch.equal(pool, before)
    with pytest.raises(ValueError, match="outside"):
        paged_copy(pool, 0, 4)
    with pytest.raises(TypeError, match="host int"):
        paged_copy(pool, torch.tensor(1), 2)


RWMA_CASES = [
    # (M, K, N, bm, bk, bn): square tiles at the port's block sizes, a
    # rectangular tiling, K of one tile, and tiles outside 8..128 powers of
    # two (the CUDA kernel's general-tile path; the JAX kernel takes any tile)
    (32, 48, 16, 16, 16, 16),
    (64, 64, 64, 8, 8, 8),
    (32, 64, 48, 16, 32, 16),
    (128, 16, 32, 32, 16, 32),
    (48, 72, 96, 24, 24, 24),
    (18, 27, 45, 9, 9, 15),
    (256, 320, 160, 256, 160, 160),
]


@pytest.mark.parametrize("M,K,N,bm,bk,bn", RWMA_CASES)
def test_rwma_plain_matches_pallas(M, K, N, bm, bk, bn):
    rng = np.random.default_rng(M + K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    out = rwma_gemm(torch.from_numpy(a), torch.from_numpy(b), bm=bm, bk=bk, bn=bn)
    want = np.asarray(jax_rwma_gemm(jnp.asarray(a), jnp.asarray(b), bm=bm, bk=bk, bn=bn,
                                    interpret=True))
    assert out.dtype == torch.float32 and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
    plain = rwma_plain(torch.from_numpy(a), torch.from_numpy(b), bm=bm, bk=bk, bn=bn)
    assert torch.equal(out, plain)


def test_rwma_divisibility_and_type_errors():
    a, b = torch.zeros(24, 16), torch.zeros(16, 16)
    with pytest.raises(ValueError, match="not divisible by blocks"):
        rwma_gemm(a, b, bm=16, bk=16, bn=16)
    with pytest.raises(ValueError, match="not divisible by blocks"):
        jax_rwma_gemm(jnp.zeros((24, 16)), jnp.zeros((16, 16)), bm=16, bk=16, bn=16,
                      interpret=True)
    with pytest.raises(ValueError, match="inner dims mismatch"):
        rwma_gemm(torch.zeros(16, 16), torch.zeros(32, 16), bm=16, bk=16, bn=16)
    with pytest.raises(TypeError, match="fp32"):  # bf16 runs (widened); float64 does not
        rwma_gemm(torch.zeros(16, 16, dtype=torch.float64),
                  torch.zeros(16, 16, dtype=torch.float64), bm=16, bk=16, bn=16)
    with pytest.raises(ValueError, match="tiles must be positive"):
        rwma_gemm(torch.zeros(24, 24), torch.zeros(24, 24), bm=0, bk=24, bn=24)
