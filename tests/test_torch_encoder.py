"""The PyTorch port's blocked encoder against the JAX package's, end to end.

The JAX weights (``enc.init_params``) are carried across with
``params_from_numpy``; the inputs are made with numpy.  The port's ``"cuda"``
backend runs its kernels' plain versions here (the tensors lie on the CPU)
and is held against JAX ``encoder_bwma(backend="pallas", interpret=True)``
within 1e-4 and ``encoder_rwma`` within 5e-4, the tolerances of
tests/test_backend.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import repro_torch.kernels as tk
from repro.core import backend as jbackend
from repro.core import encoder as jenc
from repro_torch.core import backend as tbackend
from repro_torch.core import blockwise as tbw
from repro_torch.core import encoder as tenc

CONFIGS = {
    # tests/test_encoder_end_to_end.py
    "end_to_end": dict(seq_len=64, d_model=96, n_heads=3, d_head=32, d_ff=128,
                       n_layers=2, block=16),
    # tests/test_backend.py:60: seq, d_model and d_head all ragged
    "ragged": dict(seq_len=45, d_model=72, n_heads=2, d_head=20, d_ff=80,
                   n_layers=2, block=16),
    "block8": dict(seq_len=64, d_model=96, n_heads=3, d_head=32, d_ff=128,
                   n_layers=2, block=8),
    # d_head == block: the merged heads are one column block each
    "head_is_block": dict(seq_len=32, d_model=48, n_heads=2, d_head=16, d_ff=64,
                          n_layers=1, block=16),
}


def _setup(kw, seed, batch=None):
    jcfg, tcfg = jenc.EncoderConfig(**kw), tenc.EncoderConfig(**kw)
    params = jenc.init_params(jax.random.PRNGKey(seed), jcfg)
    shape = (jcfg.seq_len, jcfg.d_model) if batch is None else (batch, jcfg.seq_len, jcfg.d_model)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    tparams = tenc.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams, x


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_matches_jax(name, batch):
    jcfg, tcfg, params, tparams, x = _setup(CONFIGS[name], seed=len(name), batch=batch)
    y_pal = np.asarray(jenc.encoder_bwma(jenc.block_params(params, jcfg), x, jcfg,
                                         backend="pallas", interpret=True))
    bp = tenc.block_params(tparams, tcfg, device="cpu")
    xt = torch.from_numpy(x)
    y_cuda = tenc.encoder_bwma(bp, xt, tcfg)  # default backend: "cuda"
    y_ref = tenc.encoder_bwma(bp, xt, tcfg, backend="reference")
    assert tuple(y_cuda.shape) == x.shape and torch.isfinite(y_cuda).all()
    assert np.abs(y_cuda.numpy() - y_pal).max() <= 1e-4
    assert np.abs(y_ref.numpy() - y_pal).max() <= 1e-4
    assert (y_cuda - y_ref).abs().max().item() <= 1e-4
    x0 = x if batch is None else x[0]
    y_rw = np.asarray(jenc.encoder_rwma(params, x0, jcfg))
    y0 = y_cuda.numpy() if batch is None else y_cuda[0].numpy()
    np.testing.assert_allclose(y0, y_rw, rtol=5e-4, atol=5e-4)
    t_rw = tenc.encoder_rwma(tparams, torch.from_numpy(x0), tcfg).numpy()
    np.testing.assert_allclose(t_rw, y_rw, rtol=5e-4, atol=5e-4)
    # on the CPU the wrappers take their plain versions and launch nothing
    assert set(tk.launch_counts().values()) == {0}


def test_block_params_match_jax():
    jcfg, tcfg, params, tparams, _ = _setup(CONFIGS["ragged"], seed=3)
    jb = jenc.block_params(params, jcfg)
    tb = tenc.block_params(tparams, tcfg, device="cpu")
    for jl, tl in zip(jb, tb):
        assert set(jl) == set(tl)
        for k in jl:
            assert tl[k].is_contiguous()
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))


def test_resolve_backend_is_the_ports_own():
    assert set(tbackend.BACKENDS) == {"reference", "cuda"}
    assert "cuda" not in jbackend.BACKENDS  # the JAX registry is untouched
    assert isinstance(tbackend.resolve_backend(None), tbackend.CudaBackend)
    assert tbackend.resolve_backend("cuda") is tbackend.resolve_backend(None)
    ref = tbackend.resolve_backend("reference")
    assert isinstance(ref, tbackend.ReferenceBackend) and tbackend.resolve_backend(ref) is ref
    with pytest.raises(ValueError, match="unknown backend"):
        tbackend.resolve_backend("pallas")
    with pytest.raises(ValueError, match="interpret"):
        tbackend.resolve_backend("cuda", interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        tbackend.resolve_backend(ref, interpret=False)
    with pytest.raises(TypeError):
        tbackend.resolve_backend(3)
    cfg = tenc.EncoderConfig(**CONFIGS["head_is_block"])
    with pytest.raises(ValueError, match="interpret"):
        tenc.encoder_bwma([], torch.zeros(cfg.seq_len, cfg.d_model), cfg, interpret=True)


def test_unported_kernel_ops_raise_not_implemented():
    """Every kernel op of both backends is ported now: on CPU tensors the
    cuda backend's softmax, transpose and MLA decode run their kernels'
    plain versions and agree with the reference backend; none raises."""
    be, ref = tbackend.resolve_backend("cuda"), tbackend.resolve_backend("reference")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((20, 24)).astype(np.float32))
    a = tbw.block(x, tenc.EncoderConfig(block=16).layout)
    torch.testing.assert_close(be.softmax(a).unblock(), torch.softmax(x, -1),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(be.transpose(a).unblock(), x.T)
    assert torch.equal(be.transpose(a).data, ref.transpose(a).data)
    rng = np.random.default_rng(1)
    q_lat, q_rope = (torch.from_numpy(rng.standard_normal((2, 1, 3, n)).astype(np.float32))
                     for n in (8, 4))
    ckv, krope = (torch.from_numpy(rng.standard_normal((5, 4, n)).astype(np.float32))
                  for n in (8, 4))
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    seq = torch.tensor([6, 2], dtype=torch.int32)
    outs = [b.mla_paged_attention_decode(q_lat, q_rope, ckv, krope, table, seq, scale=0.3)
            for b in (be, ref)]
    assert outs[0].shape == (2, 1, 3, 8)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)
    pool = torch.arange(24.0).reshape(1, 3, 2, 4)
    assert torch.equal(be.paged_copy_page({"k": pool}, 0, 2)["k"][:, 2], pool[:, 0])


def test_init_params_shapes_and_seeding():
    kw = CONFIGS["ragged"]
    jp = jenc.init_params(jax.random.PRNGKey(0), jenc.EncoderConfig(**kw))
    cfg = tenc.EncoderConfig(**kw)
    tp = tenc.init_params(cfg, device="cpu")
    assert len(tp) == len(jp)
    for jl, tl in zip(jp, tp):
        assert {k: tuple(v.shape) for k, v in tl.items()} == {k: v.shape for k, v in jl.items()}
        assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in tl.values())
    again = tenc.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(again[1]["w1"], tp[1]["w1"], rtol=0, atol=0)


def test_bert_base_config_matches_jax():
    for block in (16, 128):
        j, t = jenc.bert_base_config(block=block), tenc.bert_base_config(block=block)
        for f in ("seq_len", "d_model", "n_heads", "d_head", "d_ff", "n_layers", "block"):
            assert getattr(t, f) == getattr(j, f)
        assert t.dtype == torch.float32 and t.layout.bm == block
