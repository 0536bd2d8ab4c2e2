"""The port's LayerNorm and attention in bf16 against the JAX package, on the CPU.

The JAX kernels ``bwma_layernorm`` and ``bwma_attention`` are dtype-generic:
they compute in fp32 and return the input's type (x's, q's), gamma/beta
widened by promotion whatever their own type.  The port does the same: its
plain versions here, its CUDA LayerNorm reading bf16 itself and its CUDA
attention widening bf16 on the device.  Held here against Pallas interpret
mode at 2e-2, the bf16 tolerance of tests/test_kernels.py, with every output
dtype checked.  Inputs come from a numpy seed and are rounded to bf16 once,
the same way on both sides.  The CUDA branch of each wrapper is driven
against a stand-in library to pin what reaches the kernel.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import repro_torch.kernels as tk
from repro.core import blockwise as jbw
from repro.core.layout import BlockLayout as JLayout
from repro.kernels.bwma_attention import bwma_attention as jax_attention
from repro.kernels.bwma_layernorm import bwma_layernorm as jax_layernorm
from repro_torch.core import blockwise as tbw
from repro_torch.core.layout import BlockLayout
from repro_torch.kernels import _build

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _fresh_counts():
    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()


def _both(seed, *shape, dtype="bfloat16", scale=1.0, shift=0.0):
    """The same values as a torch tensor and a JAX array of ``dtype``,
    rounded once."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)
    if dtype == "float32":
        return torch.from_numpy(x), jnp.asarray(x)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# (gn, block, full width, ragged n_logical): the ragged widths end part-way
# into a 16-byte vector of the kernel (not a multiple of 8)
LN_WIDTHS = {8: (3, 24, 19), 16: (3, 48, 37), 128: (2, 256, 201)}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", list(LN_WIDTHS))
@pytest.mark.parametrize("lead", [(), (2,), (2, 3), (3, 1)])
@pytest.mark.parametrize("ragged", [False, True])
def test_layernorm_bf16_matches_pallas(param_dtype, block, lead, ragged):
    gn, full, short = LN_WIDTHS[block]
    n = short if ragged else full
    x_t, x_j = _both(block + len(lead), *lead, 2, gn, block, block, scale=3.0, shift=1.0)
    g_t, g_j = _both(6, gn, block, dtype=param_dtype, shift=1.0)
    b_t, b_j = _both(7, gn, block, dtype=param_dtype)
    want = jax_layernorm(x_j, g_j, b_j, n, interpret=True)
    got = tk.bwma_layernorm(x_t, g_t, b_t, n)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape
    # padded columns are written as exactly 0 by both: compare every element
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)
    assert tk.launch_counts()["bwma_layernorm"] == 0  # no launch on the CPU


@pytest.mark.parametrize("x_dtype,param_dtype", [("float32", "bfloat16"),
                                                 ("bfloat16", "float32")])
def test_layernorm_blocked_result_keeps_the_input_dtype(x_dtype, param_dtype):
    m, d = 40, 72
    lo, jlo = BlockLayout(16, 16), JLayout(16, 16)
    x_t, x_j = _both(1, m, d, dtype=x_dtype, scale=2.0)
    g_t, g_j = _both(2, d, dtype=param_dtype, shift=1.0)
    b_t, b_j = _both(3, d, dtype=param_dtype)
    want = jax_layernorm(jbw.block(x_j, jlo), jbw.block_vector(g_j, jlo),
                         jbw.block_vector(b_j, jlo), interpret=True)
    got = tk.bwma_layernorm(tbw.block(x_t, lo), tbw.block_vector(g_t, lo),
                            tbw.block_vector(b_t, lo))
    assert isinstance(got, tbw.Blocked) and got.shape == (m, d)
    assert got.dtype == x_t.dtype and want.dtype == x_j.dtype
    tol = BF16_TOL if x_dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_f32(got.unblock()), _f32(want.unblock()), **tol)


ATTN_BF16_CASES = [
    # (q lead, kv lead, gs, gd, block, s_logical): ragged keys under batch x
    # heads, K/V broadcast over the query heads, block 128 (d_head 64 padded)
    ((2, 3), (2, 3), 3, 2, 16, 45),
    ((3,), (1,), 2, 3, 8, 16),
    ((2,), (2,), 8, 4, 16, 128),
    ((1, 2), (1, 2), 4, 1, 128, 500),
]


@pytest.mark.parametrize("lq,lkv,gs,gd,block,s_logical", ATTN_BF16_CASES)
def test_attention_bf16_matches_pallas(lq, lkv, gs, gd, block, s_logical):
    q_t, q_j = _both(8, *lq, gs, gd, block, block)
    k_t, k_j = _both(9, *lkv, gs, gd, block, block)
    v_t, v_j = _both(10, *lkv, gs, gd, block, block)
    want = jax_attention(q_j, k_j, v_j, scale=0.3, s_logical=s_logical, interpret=True)
    got = tk.bwma_attention(q_t, k_t, v_t, scale=0.3, s_logical=s_logical)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape
    # padded query rows are garbage by design: compare the logical rows
    rows = np.arange(gs * block).reshape(gs, 1, block, 1) < s_logical
    np.testing.assert_allclose(np.where(rows, _f32(got), 0), np.where(rows, _f32(want), 0),
                               **BF16_TOL)
    assert tk.launch_counts()["bwma_attention"] == 0


def test_attention_blocked_result_keeps_the_input_dtype():
    s, dh = 40, 24
    lo, jlo = BlockLayout(16, 16), JLayout(16, 16)
    qkv = [_both(seed, 2, s, dh) for seed in (11, 12, 13)]
    want = jax_attention(*(jbw.block(j, jlo) for _, j in qkv), scale=dh ** -0.5,
                         interpret=True)
    got = tk.bwma_attention(*(tbw.block(t, lo) for t, _ in qkv), scale=dh ** -0.5)
    assert isinstance(got, tbw.Blocked) and got.shape == (s, dh)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got.unblock()), _f32(want.unblock()), **BF16_TOL)


@pytest.mark.parametrize("bad", [torch.float64, torch.float16, torch.int32])
def test_layernorm_and_attention_still_refuse_other_types_and_strided_operands(bad):
    x = torch.zeros(2, 2, 16, 16)
    g = torch.ones(2, 16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tk.bwma_layernorm(x.to(bad), g, g, 32)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tk.bwma_layernorm(x.bfloat16(), g.to(bad), g, 32)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tk.bwma_attention(x.to(bad), x.to(bad), x.to(bad), scale=1.0, s_logical=32)
    # a strided view: the answer on its contiguous copy, bit for bit
    xb = _both(9, 2, 2, 16, 16)[0]
    view = xb.transpose(-1, -2)
    assert torch.equal(tk.bwma_layernorm(view, g, g, 32),
                       tk.bwma_layernorm(view.contiguous(), g, g, 32))
    assert torch.equal(tk.bwma_attention(view, xb, xb, scale=1.0, s_logical=32),
                       tk.bwma_attention(view.contiguous(), xb, xb, scale=1.0, s_logical=32))
    assert tk.launch_counts() == dict.fromkeys(tk.launch_counts(), 0)


class _FakeLib:
    """Records each kernel entry point it is called at, with its arguments;
    a CTA's shared-memory query answers 1 byte (any size that fits)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 1 if name.endswith("_smem_bytes") else 0
        return entry


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


@pytest.mark.parametrize("x_dtype,param_dtype", [(torch.bfloat16, torch.float32),
                                                 (torch.bfloat16, torch.bfloat16),
                                                 (torch.float32, torch.bfloat16),
                                                 (torch.float32, torch.float32)])
def test_cuda_branch_hands_layernorm_its_operands_unwidened(fake_card, x_dtype, param_dtype):
    """The LayerNorm kernel reads bf16 itself: each operand reaches it in
    its own type, with flags that say which are bf16, once per call, and
    the result has x's type."""
    lib, seen = fake_card
    x = torch.zeros(2, 3, 2, 16, 16, dtype=x_dtype)
    g = torch.zeros(2, 16, dtype=param_dtype)
    out = tk.bwma_layernorm(x, g, g, 30)
    assert out.dtype == x_dtype and tuple(out.shape) == tuple(x.shape)
    assert seen == [x_dtype, param_dtype, param_dtype, x_dtype]
    (name, args), = lib.calls
    assert name == "bwma_layernorm"
    bf16 = torch.bfloat16
    assert args[4:7] == (x_dtype == bf16, param_dtype == bf16, param_dtype == bf16)
    assert tk.launch_counts()["bwma_layernorm"] == 1


def test_cuda_branch_widens_attention_and_rounds_its_result_once(fake_card):
    """bf16 q/k/v reach the fp32 attention kernel widened; the result is
    cast back to q's type."""
    lib, seen = fake_card
    q = torch.zeros(2, 4, 2, 16, 16, dtype=torch.bfloat16)
    out = tk.bwma_attention(q, q, q, scale=0.25, s_logical=60)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(q.shape)
    assert set(seen) == {torch.float32}
    assert [name for name, _ in lib.calls] == ["bwma_attention_smem_bytes",
                                               "bwma_attention_f32"]
    assert tk.launch_counts()["bwma_attention"] == 1
