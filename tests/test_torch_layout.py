"""The PyTorch port's layout module against the JAX package's, bitwise."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import layout as jlayout
from repro_torch.core import layout as tlayout

SHAPES = [
    # (lead, m, n, bm, bn): ragged, exact, rectangular blocks, with lead dims
    ((), 45, 72, 16, 16),
    ((), 5, 7, 8, 8),
    ((), 64, 96, 16, 16),
    ((), 33, 20, 8, 16),
    ((3,), 45, 72, 16, 16),
    ((2, 3), 17, 9, 8, 8),
]


def _x(lead, m, n, seed=0):
    return np.random.default_rng(seed).standard_normal((*lead, m, n)).astype(np.float32)


@pytest.mark.parametrize("lead,m,n,bm,bn", SHAPES)
def test_to_from_blockwise_bitwise_equal_to_jax(lead, m, n, bm, bn):
    x = _x(lead, m, n)
    jl, tl = jlayout.BlockLayout(bm, bn), tlayout.BlockLayout(bm, bn)
    want = np.asarray(jlayout.to_blockwise(x, jl))
    got = tlayout.to_blockwise(torch.from_numpy(x), tl)
    assert got.is_contiguous()  # the memory order is the blocked one
    np.testing.assert_array_equal(got.numpy(), want)
    back = tlayout.from_blockwise(got, tl, (m, n))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jlayout.from_blockwise(want, jl, (m, n)))
    )


@pytest.mark.parametrize("lead,m,n,bm,bn", SHAPES)
def test_pad2d_and_1d_view_bitwise_equal_to_jax(lead, m, n, bm, bn):
    x = _x(lead, m, n, seed=1)
    jl, tl = jlayout.BlockLayout(bm, bn), tlayout.BlockLayout(bm, bn)
    np.testing.assert_array_equal(
        tlayout.pad2d(torch.from_numpy(x), tl).numpy(), np.asarray(jlayout.pad2d(x, jl))
    )
    tb = tlayout.to_blockwise(torch.from_numpy(x), tl).numpy()
    jb = np.asarray(jlayout.to_blockwise(x, jl))
    np.testing.assert_array_equal(tlayout.blockwise_1d_view(tb), jlayout.blockwise_1d_view(jb))


@pytest.mark.parametrize("shape", [(45, 72), (16, 16), (1, 129), (300, 7)])
@pytest.mark.parametrize("bm,bn", [(8, 8), (16, 16), (128, 128), (8, 32)])
def test_block_layout_geometry_matches_jax(shape, bm, bn):
    jl, tl = jlayout.BlockLayout(bm, bn), tlayout.BlockLayout(bm, bn)
    assert tl.padded_shape(shape) == jl.padded_shape(shape)
    assert tl.grid(shape) == jl.grid(shape)
    assert tl.blocked_shape(shape) == jl.blocked_shape(shape)
    assert tlayout.ceil_to(shape[0], bm) == jlayout.ceil_to(shape[0], bm)


def test_layout_policy_and_validation():
    assert {p.value for p in tlayout.LayoutPolicy} == {p.value for p in jlayout.LayoutPolicy}
    with pytest.raises(ValueError):
        tlayout.BlockLayout(0, 16)
    xb = tlayout.to_blockwise(torch.zeros(16, 16), tlayout.BlockLayout(8, 8))
    with pytest.raises(ValueError):
        tlayout.from_blockwise(xb, tlayout.BlockLayout(16, 16), (16, 16))
