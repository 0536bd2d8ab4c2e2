"""The port's GEMM routes in bf16 against the JAX package, on the CPU.

The JAX GEMM kernels are dtype-generic: bf16 operands, an fp32 accumulator,
a raw result in fp32 (``acc_dtype``) and a ``Blocked`` result cast back to
the input dtype; ``models/common.py:dense`` returns ``x.dtype``.  The port
widens bf16 operands to fp32 and runs its fp32 kernels (a product of two
bf16 values is exact in fp32).  Held here against Pallas interpret mode at
2e-2, the bf16 tolerance of tests/test_kernels.py, over its shapes, with
every output dtype checked.  Inputs come from a numpy seed and are rounded
to bf16 the same way on both sides.
"""
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import repro.configs as JC
import repro_torch.configs as TC
import repro_torch.kernels as tk
from repro.core import blockwise as jbw
from repro.core.layout import BlockLayout as JLayout
from repro.core.layout import from_blockwise as j_from_blockwise
from repro.core.layout import to_blockwise as j_to_blockwise
from repro.kernels.bwma_fused_ffn import bwma_fused_ffn as jax_fused_ffn
from repro.kernels.bwma_gemm import bwma_gemm as jax_bwma_gemm
from repro.kernels.rwma_gemm import rwma_gemm as jax_rwma_gemm
from repro.models import common as jcommon
from repro_torch.core import blockwise as tbw
from repro_torch.core.layout import BlockLayout, from_blockwise, to_blockwise
from repro_torch.kernels import _build
from repro_torch.models import common as tcommon

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GEMM_SHAPES = [  # tests/test_kernels.py:GEMM_SHAPES
    (16, 16, 16), (32, 64, 16), (48, 80, 64), (96, 32, 48), (128, 128, 128), (17, 33, 9),
]


@pytest.fixture(autouse=True)
def _fresh_counts():
    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()


def _bf16(seed, *shape, scale=1.0):
    """A bf16 operand for both packages: the same values, rounded once."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_bwma_gemm_bf16_matches_pallas(m, k, n):
    a_t, a_j = _bf16(m, m, k)
    b_t, b_j = _bf16(n, k, n)
    lo, jlo = BlockLayout(16, 16), JLayout(16, 16)
    want = jax_bwma_gemm(j_to_blockwise(a_j, jlo), j_to_blockwise(b_j, jlo), interpret=True)
    got = tk.bwma_gemm(to_blockwise(a_t, lo), to_blockwise(b_t, lo))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # the raw accumulator
    np.testing.assert_allclose(from_blockwise(got, lo, (m, n)).numpy(),
                               _f32(j_from_blockwise(want, jlo, (m, n))), **BF16_TOL)
    assert tk.launch_counts()["bwma_gemm"] == 0  # no launch on the CPU


@pytest.mark.parametrize("m,k,n", [(32, 64, 16), (48, 80, 64), (17, 33, 9)])
def test_bwma_gemm_bf16_blocked_result_keeps_the_input_dtype(m, k, n):
    a_t, a_j = _bf16(m + 1, m, k)
    b_t, b_j = _bf16(n + 1, k, n)
    want = jax_bwma_gemm(jbw.block(a_j, JLayout(16, 16)), jbw.block(b_j, JLayout(16, 16)),
                         interpret=True)
    got = tk.bwma_gemm(tbw.block(a_t, BlockLayout(16, 16)), tbw.block(b_t, BlockLayout(16, 16)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.unblock().float().numpy(), _f32(want.unblock()), **BF16_TOL)


@pytest.mark.parametrize("m,k,n", [(32, 64, 16), (64, 32, 64)])  # tests/test_kernels.py
def test_rwma_gemm_bf16_matches_pallas(m, k, n):
    a_t, a_j = _bf16(2, m, k)
    b_t, b_j = _bf16(3, k, n)
    want = jax_rwma_gemm(a_j, b_j, bm=16, bk=16, bn=16, interpret=True)
    got = tk.rwma_gemm(a_t, b_t, bm=16, bk=16, bn=16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), _f32(want), **BF16_TOL)


@pytest.mark.parametrize("wrapped", [False, True])
def test_fused_ffn_bf16_matches_pallas(wrapped):
    m, k, n = 48, 80, 64
    lo, jlo = BlockLayout(16, 16), JLayout(16, 16)
    a_t, a_j = _bf16(4, m, k)
    w_t, w_j = _bf16(5, k, n, scale=0.2)
    bias = (np.random.default_rng(6).standard_normal(n) * 0.5).astype(np.float32)
    bias_t = tbw.block_vector(torch.from_numpy(bias), lo)
    bias_j = jbw.block_vector(jnp.asarray(bias), jlo)
    if wrapped:
        want = jax_fused_ffn(jbw.block(a_j, jlo), jbw.block(w_j, jlo), bias_j, interpret=True)
        got = tk.bwma_fused_ffn(tbw.block(a_t, lo), tbw.block(w_t, lo), bias_t)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        got, want = got.unblock().float().numpy(), _f32(want.unblock())
    else:
        want = jax_fused_ffn(j_to_blockwise(a_j, jlo), j_to_blockwise(w_j, jlo), bias_j,
                             interpret=True)
        got = tk.bwma_fused_ffn(to_blockwise(a_t, lo), to_blockwise(w_t, lo), bias_t)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        got, want = got.numpy(), _f32(want)
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("arch", ["minicpm-2b", "starcoder2-7b"])
@pytest.mark.parametrize("gemm_backend", ["bwma", "rwma"])
def test_dense_bf16_matches_jax(arch, gemm_backend):
    """``dense`` on a smoke config in bf16 (the configs' default type), both
    kernel routes, against the JAX ``dense`` on the same weights."""
    jc = dataclasses.replace(JC.get_config(arch, smoke=True), gemm_backend=gemm_backend,
                             block=16)
    tc = dataclasses.replace(TC.get_config(arch, smoke=True), gemm_backend=gemm_backend,
                             block=16)
    assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16
    x_t, x_j = _bf16(7, 2, 16, tc.d_model)
    w_t, w_j = _bf16(8, tc.d_model, 3 * 16, scale=tc.d_model ** -0.5)
    want = jcommon.dense(jc, x_j, w_j)
    got = tcommon.dense(tc, x_t, w_t)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape == (2, 16, 48)
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **BF16_TOL)


@pytest.mark.parametrize("kernel", ["bwma_gemm", "bwma_fused_ffn", "rwma_gemm"])
def test_gemms_still_refuse_other_types_and_strided_operands(kernel):
    a = torch.zeros(2, 2, 16, 16)
    bias = torch.zeros(2, 16)

    def call(x, y):
        if kernel == "rwma_gemm":
            return tk.rwma_gemm(x.reshape(64, 16), y.reshape(64, 16)[:16], bm=16, bk=16, bn=16)
        if kernel == "bwma_fused_ffn":
            return tk.bwma_fused_ffn(x, y, bias)
        return tk.bwma_gemm(x, y)

    for bad in (torch.float64, torch.int32, torch.float16):
        with pytest.raises(TypeError, match="fp32 or bf16"):
            call(a.to(bad), a.to(bad))
    with pytest.raises(ValueError, match="contiguous"):
        if kernel == "rwma_gemm":
            tk.rwma_gemm(torch.zeros(16, 32).t(), torch.zeros(16, 16), bm=16, bk=16, bn=16)
        else:
            call(a.to(torch.bfloat16).transpose(-1, -2), a.to(torch.bfloat16))
    assert tk.launch_counts() == dict.fromkeys(tk.launch_counts(), 0)


class _FakeLib:
    """Records the kernel entry points and the operand types they get."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append(name) or 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    seen = []
    real_args = _build.launch_args

    def launch_args(*tensors):
        seen.extend(t.dtype for t in tensors)
        return real_args(*tensors)

    monkeypatch.setattr(_build, "on_cuda", lambda kernel, *t: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "launch_args", launch_args)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return lib, seen


@pytest.mark.parametrize("kernel,entry", [("bwma_gemm", "bwma_gemm_f32"),
                                          ("bwma_fused_ffn", "bwma_fused_ffn_f32"),
                                          ("rwma_gemm", "rwma_gemm_f32")])
def test_cuda_branch_widens_bf16_before_its_fp32_kernel(fake_card, kernel, entry):
    """On a CUDA tensor the wrapper hands the fp32 kernel widened copies of
    bf16 operands, launches once, and returns the reference's dtypes."""
    lib, seen = fake_card
    lo = BlockLayout(16, 16)
    a = tbw.block(torch.zeros(32, 48, dtype=torch.bfloat16), lo)
    w = tbw.block(torch.zeros(48, 32, dtype=torch.bfloat16), lo)
    if kernel == "rwma_gemm":
        out = tk.rwma_gemm(a.unblock(), w.unblock(), bm=16, bk=16, bn=16)
        assert out.dtype == torch.float32
    elif kernel == "bwma_fused_ffn":
        out = tk.bwma_fused_ffn(a, w, torch.zeros(2, 16, dtype=torch.bfloat16))
        assert out.dtype == torch.bfloat16 and tk.bwma_fused_ffn(a.data, w.data, torch.zeros(
            2, 16, dtype=torch.bfloat16)).dtype == torch.float32
    else:
        out = tk.bwma_gemm(a, w)
        assert out.dtype == torch.bfloat16 and tk.bwma_gemm(a.data, w.data).dtype == torch.float32
    assert set(lib.calls) == {entry} and set(seen) == {torch.float32}
    assert tk.launch_counts()[kernel] == len(lib.calls)


@pytest.mark.parametrize("a_dtype,b_dtype", [(torch.float32, torch.float32),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
def test_as_fp32_widens_only_bf16_operands(a_dtype, b_dtype):
    """fp32 operands reach the kernel as they are (no copy on the fp32
    path); a bf16 one of a mixed pair is widened alone."""
    a, b = torch.ones(4, 8, dtype=a_dtype), torch.ones(8, 4, dtype=b_dtype)
    wa, wb, none = _build.as_fp32(a, b, None)
    assert none is None and wa.dtype == wb.dtype == torch.float32
    assert (wa is a) == (a_dtype == torch.float32) and (wb is b) == (b_dtype == torch.float32)
    assert torch.equal(wa, a.float()) and torch.equal(wb, b.float())
