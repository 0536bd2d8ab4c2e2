"""The port's blocked softmax and blocked transpose against the JAX Pallas
kernels, on the CPU.

On the CPU each wrapper takes its kernel's plain version (the tensors lie on
the CPU).  Held here against the JAX package's kernels in interpret mode on
the sweeps of tests/test_kernels.py: the softmax within 2e-5 in fp32 and the
JAX suite's bf16 tolerance (2e-2: the Pallas kernel computes in bf16, the
port in fp32 with one rounding) in bf16, also against a plain row softmax;
the transpose bit-exact.  Both also go through the ``Backend`` protocol
(``CudaBackend.softmax`` / ``.transpose``, ``ops.blocked_softmax``) against
the JAX ``PallasBackend``.  The compiled CUDA kernels are held against these
plain versions on the card by the ``cuda`` cases of test_torch_kernels.py.
All inputs come from a numpy seed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import repro_torch.kernels as tk
from repro.core import backend as jbackend
from repro.core import blockwise as jbw
from repro.core.layout import BlockLayout as JLayout
from repro.core.layout import from_blockwise as jfrom_blockwise
from repro.core.layout import to_blockwise as jto_blockwise
from repro.kernels.bwma_softmax import bwma_softmax as jax_softmax
from repro.kernels.bwma_transpose import bwma_transpose as jax_transpose
from repro_torch.core import backend as tbackend
from repro_torch.core import blockwise as tbw
from repro_torch.core.layout import BlockLayout, from_blockwise, to_blockwise
from repro_torch.kernels import ops
from repro_torch.kernels.bwma_softmax import bwma_softmax, softmax_plain
from repro_torch.kernels.bwma_transpose import bwma_transpose, transpose_plain

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _no_launches_on_the_cpu():
    tk.reset_launch_counts()
    yield
    assert all(n == 0 for n in tk.launch_counts().values()), "a kernel launched on the CPU"


def _both(x_np, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(x_np).to(tdt)
    return t, jnp.asarray(x_np).astype(jdt)


def _np32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("m,n", [(16, 16), (32, 48), (40, 70), (8, 130)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_softmax_plain_matches_pallas(m, n, dtype):
    x, jx = _both(np.random.default_rng(m * n).standard_normal((m, n)).astype(np.float32) * 2,
                  dtype)
    lo, jlo = BlockLayout(16, 16), JLayout(16, 16)
    got = from_blockwise(bwma_softmax(to_blockwise(x, lo), n), lo, (m, n))
    want = jfrom_blockwise(jax_softmax(jto_blockwise(jx, jlo), n, interpret=True), jlo, (m, n))
    assert got.dtype == x.dtype
    np.testing.assert_allclose(_np32(got), _np32(want), **_tol(dtype))
    np.testing.assert_allclose(_np32(got), torch.softmax(x.float(), -1).numpy(), **_tol(dtype))


def test_softmax_masks_padded_columns_and_folds_lead_dims():
    """Leading (batch, head) dims fold into the launch grid; padded columns
    come out as exactly 0 and each logical row sums to 1."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 40, 70)).astype(np.float32) * 3
    lo = BlockLayout(16, 16)
    xb = to_blockwise(torch.from_numpy(x), lo)  # (2, 3, 3, 5, 16, 16): 10 padded columns
    out = bwma_softmax(xb, 70)
    col = torch.arange(5 * 16).reshape(5, 1, 16)
    assert torch.all(torch.where(col >= 70, out, 0.0) == 0.0)
    want = jax_softmax(jnp.asarray(xb.numpy()), 70, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    rows = from_blockwise(out, lo, (40, 70))
    torch.testing.assert_close(rows.sum(-1), torch.ones(2, 3, 40), rtol=2e-5, atol=2e-5)


def test_softmax_plain_equals_the_reference_blockwise_op_in_fp32():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((48, 80)).astype(np.float32))
    a = tbw.block(x, BlockLayout(16, 16))
    torch.testing.assert_close(softmax_plain(a.data, 80), tbw.bw_softmax(a).data,
                               rtol=0, atol=1e-7)


def test_softmax_requires_n_logical_and_rejects_bad_operands():
    x = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="n_logical is required"):
        bwma_softmax(x)
    with pytest.raises(ValueError, match="outside"):
        bwma_softmax(x, 17)
    with pytest.raises(TypeError, match="must be one of"):
        bwma_softmax(x.double(), 16)
    with pytest.raises(ValueError, match="4 blocked dims"):
        bwma_softmax(torch.zeros(8, 8), 8)


@pytest.mark.parametrize("m,n", [(32, 32), (48, 80), (16, 128)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_transpose_plain_matches_pallas_bit_exact(m, n, dtype):
    x, jx = _both(np.random.default_rng(m + n).standard_normal((m, n)).astype(np.float32),
                  dtype)
    lo, jlo = BlockLayout(16, 16), JLayout(16, 16)
    out = bwma_transpose(to_blockwise(x, lo))
    want = jax_transpose(jto_blockwise(jx, jlo), interpret=True)
    assert out.dtype == x.dtype and tuple(out.shape) == want.shape
    np.testing.assert_array_equal(_np32(out), _np32(want))
    assert torch.equal(from_blockwise(out, lo, (n, m)), x.T)


@pytest.mark.parametrize("bm,bn", [(16, 8), (8, 32)])
def test_transpose_swaps_a_rectangular_layout_for_any_type(bm, bn):
    """A :class:`Blocked` comes back with the swapped logical shape and
    layout; integer elements move bit for bit; leading dims are kept."""
    x = torch.arange(2 * 40 * 24, dtype=torch.int32).reshape(2, 40, 24)
    a = tbw.block(x, BlockLayout(bm, bn))
    t = bwma_transpose(a)
    assert t.shape == (24, 40) and (t.layout.bm, t.layout.bn) == (bn, bm)
    assert torch.equal(t.unblock(), x.transpose(-1, -2))
    assert torch.equal(t.data, transpose_plain(a.data))
    want = jax_transpose(jnp.asarray(a.data.numpy()), interpret=True)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(want))


def test_backend_softmax_and_transpose_match_the_pallas_backend():
    """The protocol path: ``CudaBackend.softmax`` / ``.transpose`` and
    ``ops.blocked_softmax`` against the JAX ``PallasBackend`` in interpret
    mode, and the unfused attention they compose (scores through the blocked
    transpose and GEMM) against the fused kernel."""
    rng = np.random.default_rng(6)
    S, dh = 45, 20
    q, k, v = (rng.standard_normal((S, dh)).astype(np.float32) for _ in range(3))
    lo = BlockLayout(16, 16)
    be, ref = tbackend.resolve_backend("cuda"), tbackend.resolve_backend("reference")
    jbe = jbackend.resolve_backend("pallas", interpret=True)
    tq, tk_, tv = (tbw.block(torch.from_numpy(a), lo) for a in (q, k, v))
    jq, jk = (jbw.block(jnp.asarray(a), JLayout(16, 16)) for a in (q, k))
    kt = be.transpose(tk_)
    jkt = jbe.transpose(jk)
    np.testing.assert_array_equal(kt.data.numpy(), np.asarray(jkt.data))
    scores = be.scale(be.matmul(tq, kt), dh ** -0.5)
    probs = be.softmax(scores)
    jprobs = jbe.softmax(jbe.scale(jbe.matmul(jq, jkt), dh ** -0.5))
    np.testing.assert_allclose(probs.unblock().numpy(), np.asarray(jprobs.unblock()),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(ops.blocked_softmax(scores).data, probs.data, rtol=0, atol=0)
    torch.testing.assert_close(ref.softmax(scores).unblock(), probs.unblock(),
                               rtol=2e-5, atol=2e-5)
    unfused = be.matmul(probs, tv)
    fused = be.attention(tq, tbw.block(torch.from_numpy(k), lo), tv, scale=dh ** -0.5)
    torch.testing.assert_close(unfused.unblock(), fused.unblock(), rtol=2e-5, atol=2e-5)
