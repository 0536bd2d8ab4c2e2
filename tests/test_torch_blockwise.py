"""The PyTorch port's blockwise operators against the JAX package's (2e-5)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.core import blockwise as jbw
from repro.core.layout import BlockLayout as JLayout
from repro_torch.core import blockwise as tbw
from repro_torch.core.layout import BlockLayout as TLayout

TOL = dict(rtol=2e-5, atol=2e-5)  # op level, as tests/test_backend.py
CASES = [  # (lead, m, n, block): ragged and exact, blocks 8 and 16
    ((), 45, 72, 16),
    ((), 24, 40, 8),
    ((2,), 33, 20, 8),
    ((2, 3), 32, 48, 16),
]


def _pair(lead, m, n, block, seed, scale=1.0):
    """The same blocked matrix for both packages, from numpy."""
    x = (np.random.default_rng(seed).standard_normal((*lead, m, n)) * scale).astype(np.float32)
    return (jbw.block(x, JLayout(block, block)),
            tbw.block(torch.from_numpy(x), TLayout(block, block)))


def _close(t_blocked, j_blocked, crop=True):
    """Compare after unblocking (padded rows of softmax/attention are
    garbage by design), or the raw blocked data when ``crop`` is False."""
    if crop:
        np.testing.assert_allclose(t_blocked.unblock().numpy(),
                                   np.asarray(j_blocked.unblock()), **TOL)
    else:
        np.testing.assert_allclose(t_blocked.data.numpy(), np.asarray(j_blocked.data), **TOL)
    assert t_blocked.shape == tuple(j_blocked.shape)


@pytest.mark.parametrize("lead,m,n,block", CASES)
def test_matmul_add_scale_map(lead, m, n, block):
    ja, ta = _pair(lead, m, n, block, 0)
    jb, tb = _pair((), n, 28, block, 1)
    _close(tbw.bw_matmul(ta, tb), jbw.bw_matmul(ja, jb), crop=False)
    ja2, ta2 = _pair(lead, m, n, block, 2)
    _close(tbw.bw_add(ta, ta2), jbw.bw_add(ja, ja2), crop=False)
    _close(tbw.bw_scale(ta, 0.37), jbw.bw_scale(ja, 0.37), crop=False)
    _close(tbw.bw_map(ta, tbw.gelu), jbw.bw_map(ja, jax.nn.gelu), crop=False)
    with pytest.raises(ValueError):
        tbw.bw_matmul(ta, ta2)  # inner dims mismatch


@pytest.mark.parametrize("lead,m,n,block", CASES)
def test_bias_layernorm_block_vector(lead, m, n, block):
    ja, ta = _pair(lead, m, n, block, 3, scale=3.0)
    rng = np.random.default_rng(4)
    bias, gamma, beta = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    lo_j, lo_t = JLayout(block, block), TLayout(block, block)
    jv = [jbw.block_vector(v, lo_j) for v in (bias, gamma, beta)]
    tv = [tbw.block_vector(torch.from_numpy(v), lo_t) for v in (bias, gamma, beta)]
    for j, t in zip(jv, tv):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    _close(tbw.bw_bias(ta, tv[0]), jbw.bw_bias(ja, jv[0]), crop=False)
    # padded columns come out exactly 0 in both, so compare the raw blocks
    _close(tbw.bw_layernorm(ta, tv[1], tv[2]), jbw.bw_layernorm(ja, jv[1], jv[2]), crop=False)


@pytest.mark.parametrize("lead,m,n,block", CASES)
def test_transpose_softmax(lead, m, n, block):
    ja, ta = _pair(lead, m, n, block, 5, scale=4.0)
    tt, jt = tbw.bw_transpose(ta), jbw.bw_transpose(ja)
    _close(tt, jt, crop=False)
    assert tt.layout == TLayout(jt.layout.bm, jt.layout.bn)
    _close(tbw.bw_softmax(ta), jbw.bw_softmax(ja))


@pytest.mark.parametrize("lead,s,dh,block", [((), 45, 20, 16), ((3,), 24, 16, 8),
                                             ((2, 2), 32, 32, 16)])
def test_attention_merge_heads(lead, s, dh, block):
    jq, tq = _pair(lead, s, dh, block, 6)
    jk, tk = _pair(lead, s, dh, block, 7)
    jv, tv = _pair(lead, s, dh, block, 8)
    jo = jbw.bw_attention(jq, jk, jv, scale=0.25)
    to = tbw.bw_attention(tq, tk, tv, scale=0.25)
    _close(to, jo)
    if lead:  # the last lead dim is the head axis
        _close(tbw.merge_heads(to), jbw.merge_heads(jo))


@pytest.mark.parametrize("lead,m,n,block", CASES)
def test_blocked_wrapper_and_head_axis(lead, m, n, block):
    ja, ta = _pair(lead, m, n, block, 9)
    assert ta.dtype == torch.float32 and ta.shape == (m, n)
    np.testing.assert_array_equal(ta.unblock().numpy(), np.asarray(ja.unblock()))
    th, jh = tbw.add_head_axis(ta), jbw.add_head_axis(ja)
    assert tuple(th.data.shape) == tuple(jh.data.shape)
    assert th.data.is_contiguous()
