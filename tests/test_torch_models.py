"""The port's dense/GQA model against the JAX package's, on the CPU, in fp32.

Both run the same weights -- the JAX package's ``init_params``, carried over
with ``params_from_numpy`` -- on the same tokens from a numpy seed, at smoke
size: minicpm-2b (MHA, RMSNorm, SwiGLU, tied embeddings) and starcoder2-7b
(GQA kv=2, LayerNorm, GELU, QKV bias).  Logits of ``prefill``,
``decode_step``, ``prefill_chunk`` and ``decode_step_paged`` agree within
1e-4 (the JAX suite's end-to-end tolerance); the paged steps run through
both of the port's decode backends (``"cuda"`` takes the kernels' plain
versions on the CPU).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as JC
import repro_torch.configs as TC
import repro_torch.kernels as tk
from repro.models import common as jcommon
from repro.models import model as JM
from repro_torch.models import adapters as A
from repro_torch.models import common as tcommon
from repro_torch.models import model as TM

ARCHS = ["minicpm-2b", "starcoder2-7b"]
TOL = 1e-4
PAGE = 8


def _cfgs(arch, **over):
    jc = dataclasses.replace(JC.get_config(arch, smoke=True, dtype=jnp.float32), **over)
    tc = dataclasses.replace(TC.get_config(arch, smoke=True, dtype=torch.float32), **over)
    return jc, tc


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jc, tc = _cfgs(request.param, block=PAGE)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _tokens(seed, *shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _close(a, b, tol=TOL):
    err = float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())
    assert err <= tol, err


def test_params_from_numpy_keeps_keys_shapes_and_values(setup):
    jc, tc, jp, tp = setup
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tp["seg0"]["attn"]["wq"].shape[0] == tc.n_layers  # stacked per segment


def test_params_from_numpy_carries_bf16():
    tree = {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3}
    got = TM.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(tree["w"], np.float32))


def test_common_ops_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-5)
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    for norm in ("rmsnorm", "layernorm"):
        jc, tc = _cfgs("minicpm-2b", norm=norm)
        _close(tcommon.norm_apply(tc, torch.from_numpy(w), torch.from_numpy(x),
                                  torch.from_numpy(b)),
               jcommon.norm_apply(jc, jnp.asarray(w), jnp.asarray(x), jnp.asarray(b)), 1e-5)
    # GQA chunked attention over two query chunks, offset and explicit positions
    q = rng.standard_normal((1, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 12, 2, 16)).astype(np.float32)
    kpos = np.array([[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, -1, -1]], np.int32)
    got = tcommon.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), q_offset=2,
                                    k_positions=torch.from_numpy(kpos), q_chunk=4)
    want = jcommon.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), q_offset=2,
                                     k_positions=jnp.asarray(kpos), q_chunk=4)
    _close(got, want, 1e-5)
    seq = np.array([3], np.int32)
    _close(tcommon.decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(kpos),
                                    torch.from_numpy(seq)),
           jcommon.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(kpos), jnp.asarray(seq)), 1e-5)


def test_prefill_matches_jax(setup):
    jc, tc, jp, tp = setup
    toks = _tokens(1, 2, 13)
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = TM.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tcache["seg0"]["attn"][name], jcache["seg0"]["attn"][name], 1e-5)
    # bucketed prefill reads the logits at the last real token
    padded = np.concatenate([toks, np.zeros((2, 3), np.int32)], axis=1)
    tl2, _ = TM.prefill(tc, tp, {"tokens": torch.from_numpy(padded)}, last_idx=12)
    _close(tl2, jl)


def test_decode_step_matches_jax(setup):
    jc, tc, jp, tp = setup
    toks = _tokens(2, 2, 9)
    S, max_len = toks.shape[1], 16
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = TM.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    jfull = jax.tree.map(
        lambda small, big: jax.lax.dynamic_update_slice(big, small, (0,) * big.ndim),
        jcache, JM.init_cache(jc, 2, max_len))
    tfull = TM.init_cache(tc, 2, max_len, device="cpu")
    for name, t in tcache["seg0"]["attn"].items():
        tfull["seg0"]["attn"][name][:, :, :S] = t
    for i in range(3):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jfull = JM.decode_step(jc, jp, jfull, jnp.asarray(nxt), jnp.int32(S + i))
        tl, tfull = TM.decode_step(tc, tp, tfull, torch.from_numpy(nxt), S + i)
        _close(tl, jl)


def _paged_run(model, cfg, params, caches, chunks, decode, to):
    """Drive one package's paged steps: ``chunks`` are (tokens, slot, q_off,
    phys, off, table_row, last_idx) and ``decode`` is (tokens, seq_pos,
    table, active); returns every step's logits."""
    outs = []
    for toks, slot, q_off, phys, off, row, last in chunks:
        args = (to(toks), slot, q_off, to(phys), to(off), to(row), last)
        logits, caches = model.prefill_chunk(cfg, params, caches, *args)
        outs.append(logits)
    toks, seq_pos, table, active = decode
    logits, caches = model.decode_step_paged(cfg, params, caches, to(toks), to(seq_pos),
                                             to(table), to(active))
    outs.append(logits)
    return outs, caches


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_paged_chunk_and_decode_match_jax(setup, backend):
    """Two slots prefill through the paged cache in chunks (slot 0 in two
    chunks, the second bucketed 5 -> 8), then one lockstep decode step."""
    jc, tc, jp, tp = setup
    tc = dataclasses.replace(tc, decode_backend=backend)
    maxp, num_pages = 3, 7
    table = np.array([[3, 5, 6], [2, 0, 0]], np.int32)
    p0, p1 = _tokens(3, 13), _tokens(4, 6)

    def targets(slot, start, n, real):
        pos = np.arange(start, start + n)
        phys = np.where(pos < len(real) + 1, table[slot][pos // PAGE], 0).astype(np.int32)
        return phys, (pos % PAGE).astype(np.int32)

    def chunk(slot, prompt, start, n):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = prompt[start:start + n]
        phys, off = targets(slot, start, 8, prompt)
        return toks, slot, start, phys, off, table[slot], n - 1

    chunks = [chunk(0, p0, 0, 8), chunk(0, p0, 8, 5), chunk(1, p1, 0, 6)]
    decode = (np.array([[7], [9]], np.int32), np.array([13, 6], np.int32), table,
              np.array([True, True]))
    j_outs, j_cache = _paged_run(JM, jc, jp, JM.init_paged_cache(jc, 2, num_pages, PAGE,
                                                                 maxp * PAGE),
                                 chunks, decode, jnp.asarray)
    t_caches = TM.init_paged_cache(tc, 2, num_pages, PAGE, maxp * PAGE, device="cpu")
    ptrs = [t.data_ptr() for t in t_caches["seg0"]["attn"].values()]
    t_outs, t_cache = _paged_run(TM, tc, tp, t_caches, chunks, decode, torch.from_numpy)
    for t, j in zip(t_outs, j_outs):
        _close(t, j)
    for name in ("k_pages", "v_pages"):
        got, want = t_cache["seg0"]["attn"][name], np.asarray(j_cache["seg0"]["attn"][name])
        _close(got[:, 1:], want[:, 1:], 1e-5)  # page 0 holds garbage by design
        assert got.data_ptr() in ptrs  # written in place
    assert all(n == 0 for n in tk.launch_counts().values())


def test_inactive_slot_writes_touch_only_null_page(setup):
    """A lockstep decode with slot 1 inactive (mid-prefill: its table row is
    live) writes slot 0's token into its page and slot 1's into page 0 only."""
    _, tc, _, tp = setup
    caches = TM.init_paged_cache(tc, 3, 6, PAGE, 2 * PAGE, device="cpu")
    for pool in caches["seg0"]["attn"].values():
        pool.normal_(generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in caches["seg0"]["attn"].items()}
    table = torch.tensor([[2, 4], [3, 5], [0, 0]], dtype=torch.int32)
    seq_pos = torch.tensor([9, 4, 0], dtype=torch.int32)
    active = torch.tensor([True, False, False])
    TM.decode_step_paged(tc, tp, caches, torch.tensor([[1], [2], [3]]), seq_pos, table,
                         active)
    for name, pool in caches["seg0"]["attn"].items():
        changed = (pool != before[name]).flatten(3).any(-1)  # (L, pages, page)
        touched = {(int(p), int(o)) for _, p, o in changed.nonzero().tolist()}
        assert touched == {(4, 1), (0, 4), (0, 0)}, touched


@pytest.mark.parametrize("gemm_backend", ["bwma", "rwma"])
def test_gemm_backends_match_xla(setup, gemm_backend, monkeypatch):
    """The kernel routes of ``dense`` compute the same product as ``x @ w``;
    rwma falls back to ``x @ w`` where the tile does not divide the shape,
    as in the JAX package."""
    _, tc, _, tp = setup
    toks = _tokens(5, 1, 16)
    want, _ = TM.prefill(tc, tp, {"tokens": torch.from_numpy(toks)})
    routed = dataclasses.replace(tc, gemm_backend=gemm_backend)
    from repro_torch.kernels import ops

    calls = []
    real = ops.matmul_rwma
    monkeypatch.setattr(ops, "matmul_rwma", lambda *a, **k: calls.append(1) or real(*a, **k))
    got, _ = TM.prefill(routed, tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-5)
    if gemm_backend == "rwma":
        ffn_products = 3 if "w_gate" in tp["seg0"]["ffn"] else 2
        assert len(calls) == tc.n_layers * (4 + ffn_products)  # every dense ran the kernel
        calls.clear()
        x = torch.randn(12, tc.d_model)  # tile 8 does not divide 12 rows
        torch.testing.assert_close(tcommon.dense(routed, x, tp["seg0"]["attn"]["wq"][0]),
                                   x @ tp["seg0"]["attn"]["wq"][0], rtol=1e-5, atol=1e-5)
        assert not calls


@pytest.mark.parametrize("rows,blk", [(24, 24), (96, 96), (9, 9)])
def test_rwma_dense_runs_its_kernel_at_any_dividing_tile(rows, blk, monkeypatch):
    """``dense`` clips its tile to the token count; where that tile divides
    every shape, rwma runs its kernel at it (a power of two or not), as the
    JAX package runs its Pallas kernel, and the product matches JAX's."""
    jc, tc = _cfgs("starcoder2-7b", gemm_backend="rwma")
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 4 * blk)).astype(np.float32)
    w = (rng.standard_normal((4 * blk, 2 * blk)) * 0.1).astype(np.float32)
    from repro_torch.kernels import ops

    calls = []
    real = ops.matmul_rwma
    monkeypatch.setattr(ops, "matmul_rwma",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    got = tcommon.dense(tc, torch.from_numpy(x), torch.from_numpy(w))
    assert calls == [dict(bm=blk, bk=blk, bn=blk)]
    want = np.asarray(jcommon.dense(jc, jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


SERVED = ("minicpm-2b", "starcoder2-7b", "qwen1.5-110b")  # full-attention dense/GQA


@pytest.mark.parametrize("arch", sorted(set(JC.arch_ids()) - set(SERVED)))
def test_other_families_refused_with_their_roadmap_item(arch):
    cfg = TC.get_config(arch, smoke=True, dtype=torch.float32)
    msg = A.unsupported_message(cfg)
    assert msg is not None and "ROADMAP.md queue 1 item" in msg
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        TM.init_params(cfg, device="cpu")
    assert A.supported_families() == (A.PAGED_GQA.family,)


def test_slot_row_helpers_read_and_write_one_slot():
    cache = {"k": torch.zeros(3, 4, 2), "pos": torch.full((3, 4), -1)}
    rows = A.read_slot_rows(cache, 1)
    assert rows["k"].shape == (1, 4, 2) and rows["k"].data_ptr() == cache["k"][1].data_ptr()
    A.write_slot_rows(cache, {"k": torch.ones(1, 4, 2), "pos": torch.arange(4)[None]}, 2)
    assert cache["k"][2].eq(1).all() and cache["k"][:2].eq(0).all()
    assert cache["pos"][2].tolist() == [0, 1, 2, 3] and cache["pos"][:2].eq(-1).all()
    stacked = {"k": torch.zeros(2, 3, 4)}  # (L, max_seqs, ...): the slot axis is 1
    A.write_slot_rows(stacked, {"k": torch.ones(2, 1, 4)}, 0, axis=1)
    assert stacked["k"][:, 0].eq(1).all() and stacked["k"][:, 1:].eq(0).all()


def test_dense_families_are_served():
    for arch in SERVED:
        cfg = TC.get_config(arch, smoke=True)
        assert A.unsupported_reason(cfg) is None, arch
        assert A.all_adapters(cfg) == [A.PAGED_GQA]
        assert A.prefix_shareable(cfg) and A.prefix_compute_skippable(cfg)
        assert A.prefill_chunk_multiple(cfg) == 1
