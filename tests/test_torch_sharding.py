"""The port's sharding rules against the JAX package's, spec entry for entry.

Both packages' rules run on meshes of shapes only (no process group): the
JAX ones on ``repro.distributed.axes.abstract_mesh``, the port's on its
counterpart.  A JAX ``PartitionSpec`` is compared as the tuple of its
entries, which is the port's spec.  The port's shape trees are the JAX
``eval_shape`` trees with each leaf replaced by its shape.
"""
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as JC
import repro_torch.configs as C
from repro.configs.shapes import cache_specs
from repro.distributed import sharding as JSH
from repro.distributed.axes import abstract_mesh as j_abstract_mesh
from repro.models import adapters as JA
from repro.models import model as JM
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.axes import abstract_mesh
from repro_torch.models import adapters as A
from repro_torch.models import model as M

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
    "1x2": ((1, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}


def _meshes(name):
    sizes, names = MESHES[name]
    return j_abstract_mesh(sizes, names), abstract_mesh(sizes, names)


def _shapes(tree):
    """A JAX shape tree as the port's: nested dicts of shape tuples."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _entries(tree):
    """A JAX spec tree as tuples of entries."""
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _entries(v) for k, v in tree.items()}
    raise TypeError(type(tree))


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    cfg = JC.get_config(arch)
    return jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", C.arch_ids())
def test_param_pspecs_match_jax(arch, mesh_name, mode):
    jmesh, mesh = _meshes(mesh_name)
    shapes = _param_shapes(arch)
    want = _entries(JSH.param_pspecs(JC.get_config(arch), jmesh, shapes, mode=mode))
    got = SH.param_pspecs(C.get_config(arch), mesh, _shapes(shapes), mode=mode)
    assert got == want


@pytest.mark.parametrize("arch", C.arch_ids())
def test_opt_pspecs_match_jax(arch):
    jmesh, mesh = _meshes("multi")
    shapes = _param_shapes(arch)
    jspecs = JSH.param_pspecs(JC.get_config(arch), jmesh, shapes)
    want = _entries(JSH.opt_pspecs(JC.get_config(arch), jmesh, None, jspecs))
    specs = SH.param_pspecs(C.get_config(arch), mesh, _shapes(shapes))
    assert SH.opt_pspecs(C.get_config(arch), mesh, None, specs) == want


@pytest.mark.parametrize("mesh_name", ["single", "multi", "1x4"])
@pytest.mark.parametrize("batch", [256, 32, 2, 1])
def test_batch_pspecs_match_jax(batch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    cfg = C.get_config("whisper-tiny")
    shapes = {"tokens": (batch, 4096), "labels": (batch, 4096),
              "positions3": (3, batch, 4096), "audio_embeds": (batch, 1500, 384),
              "step": ()}
    jshapes = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    want = _entries(JSH.batch_pspecs(JC.get_config("whisper-tiny"), jmesh, jshapes))
    assert SH.batch_pspecs(cfg, mesh, shapes) == want


@pytest.mark.parametrize("shape", [(128, 32768), (1, 524288), (3, 4096)])
@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", C.arch_ids())
def test_cache_pspecs_match_jax(arch, mesh_name, shape):
    jmesh, mesh = _meshes(mesh_name)
    cs = cache_specs(JC.get_config(arch), *shape)
    want = _entries(JSH.cache_pspecs(JC.get_config(arch), jmesh, cs))
    assert SH.cache_pspecs(C.get_config(arch), mesh, _shapes(cs)) == want


def _smoke(arch):
    return (JC.get_config(arch, smoke=True, dtype=jnp.float32),
            C.get_config(arch, smoke=True, dtype=torch.float32))


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", C.arch_ids())
def test_pool_and_paged_cache_pspecs_match_jax(arch, tp):
    jcfg, cfg = _smoke(arch)
    jmesh = j_abstract_mesh((1, tp), ("data", "model"))
    mesh = abstract_mesh((1, tp), ("data", "model"))
    if JA.unsupported_message(jcfg) is not None:
        assert A.unsupported_message(cfg) is not None
        with pytest.raises(NotImplementedError, match="no cache adapter"):
            SH.paged_cache_pspecs(cfg, mesh)
        return
    for jad, ad in zip(JA.all_adapters(jcfg), A.all_adapters(cfg)):
        assert type(jad).__name__ == type(ad).__name__
        assert ad.pool_pspecs(cfg, tp_size=tp) == _entries(jad.pool_pspecs(jcfg, tp_size=tp))
    pools = jax.eval_shape(lambda: JM.init_paged_cache(jcfg, 2, 5, 8, 32))
    want = _entries(JSH.paged_cache_pspecs(jcfg, jmesh, pools))
    assert SH.paged_cache_pspecs(cfg, mesh, _shapes(pools)) == want
    # without a shape tree: the leaf names of pools allocated on "meta"
    assert SH.paged_cache_pspecs(cfg, mesh) == _entries(JSH.paged_cache_pspecs(jcfg, jmesh))


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("arch", C.arch_ids())
def test_local_pools_are_the_spec_slices(arch, tp):
    """A rank's pools (``init_paged_cache(tp_size=)``) have the shapes of
    the full pools' slices under the adapters' specs, leaf for leaf."""
    _, cfg = _smoke(arch)
    if A.unsupported_message(cfg) is not None:  # Server-only: no paged pools
        with pytest.raises(NotImplementedError, match="no cache adapter"):
            M.init_paged_cache(cfg, 2, 5, 8, 32, device="meta", tp_size=tp)
        return
    mesh = abstract_mesh((1, tp), ("data", "model"))
    full = M.init_paged_cache(cfg, 2, 5, 8, 32, device="meta")
    local = M.init_paged_cache(cfg, 2, 5, 8, 32, device="meta", tp_size=tp)
    specs = SH.paged_cache_pspecs(cfg, mesh, full)
    for (path, f), (_, lo) in zip(_flat(full), _flat(local)):
        spec = dict(_flat(specs))[path]
        assert tuple(lo.shape) == tuple(SH.local_shard(f, spec, mesh).shape), path
        assert lo.dtype == f.dtype


@pytest.mark.parametrize("tp", [4, 8])
def test_validate_paged_sharding_refuses_with_the_jax_message(tp):
    jcfg, cfg = _smoke("minicpm-2b")  # n_kv_heads = 6
    jmesh = j_abstract_mesh((1, tp), ("data", "model"))
    mesh = abstract_mesh((1, tp), ("data", "model"))
    with pytest.raises(ValueError) as want:
        JSH.validate_paged_sharding(jcfg, jmesh)
    with pytest.raises(ValueError, match="n_kv_heads=6") as got:
        SH.validate_paged_sharding(cfg, mesh)
    assert str(got.value) == str(want.value)
    # 2-way divides; MLA (no paged head axis) passes at any size
    SH.validate_paged_sharding(cfg, abstract_mesh((1, 2), ("data", "model")))
    SH.validate_paged_sharding(C.get_config("deepseek-v3-671b", smoke=True), mesh)


def _normalised(spec):
    """A 1 x M serve spec as the model axis alone sees it."""
    out = []
    for e in spec:
        axes = e if isinstance(e, tuple) else (e,)
        out.append("model" if "model" in axes else None)
    return tuple(out)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", C.arch_ids())
def test_serve_placement_is_the_jax_serve_spec_or_kept_whole(arch, tp):
    """What a rank of the port holds: the JAX serve spec on a 1 x M mesh,
    leaf for leaf, except leaves kept whole -- wq_a, an attention whose
    heads the axis does not split whole, and those the serve mode shards
    only by its 2-D fallback (the base rules replicate them)."""
    jmesh, mesh = _meshes(f"1x{tp}")
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)
    shapes = _param_shapes(arch)
    jspecs = _entries(JSH.param_pspecs(jcfg, jmesh, shapes, mode="serve"))
    placed = SH.serve_placement(cfg, mesh, _shapes(shapes))
    jflat = dict(_flat(jspecs))
    kept = []
    for path, spec in _flat(placed):
        want = _normalised(jflat[path])
        if spec == want:
            continue
        assert all(e is None for e in spec), (path, spec, want)
        stacked = any(s.startswith("seg") or s in ("encoder", "cross") for s in path)
        base = JSH._base_tp_spec(path[-1], dict(_flat(_shapes(shapes)))[path],
                                 ("data", "model"), tp, stacked, jcfg)
        assert path[-1] in SH.whole_leaves(cfg, tp) or all(e is None for e in base), path
        kept.append(path[-1])
    if any(path[-1] == "wq_a" for path, _ in _flat(placed)):
        assert "wq_a" in kept


def test_local_shard_cuts_the_named_sharding_order():
    """An entry of several axes splits over their product, the first axis
    major, as a NamedSharding orders its devices."""
    mesh = abstract_mesh((2, 3), ("data", "model"))
    t = torch.arange(6 * 4).reshape(6, 4)
    for d in range(2):
        for m in range(3):
            got = SH.local_shard(t, (("data", "model"), None), mesh, {"data": d, "model": m})
            assert torch.equal(got, t[d * 3 + m:d * 3 + m + 1])
            got = SH.local_shard(t, ("data", None), mesh, {"data": d, "model": m})
            assert torch.equal(got, t[3 * d:3 * d + 3])
    with pytest.raises(ValueError, match="does not split"):
        SH.local_shard(t, (None, "model"), mesh, {"data": 0, "model": 0})


@pytest.mark.parametrize("arch", C.arch_ids())
def test_shard_params_keeps_each_ranks_slices(arch):
    """``shard_params`` on every rank of a 1 x 2 mesh: each leaf the slice
    of its placement, copied (not a view of the full tree); the slices of
    the two ranks tile the full leaf."""
    _, cfg = _smoke(arch)  # every smoke config's heads split 2 ways
    tp = 2
    mesh = abstract_mesh((1, tp), ("data", "model"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    placement = SH.serve_placement(cfg, mesh, params)
    ranks = []
    for r in range(tp):
        with mock.patch.object(SH, "mesh_coords", lambda _m, r=r: {"data": 0, "model": r}):
            ranks.append(SH.shard_params(cfg, params, mesh, torch.device("cpu")))
    pl = dict(_flat(placement))
    for path, full in _flat(params):
        spec = pl[path]
        pieces = [dict(_flat(rk))[path] for rk in ranks]
        if all(e is None for e in spec):
            assert all(p is full for p in pieces), path
            continue
        dim = next(i for i, e in enumerate(spec) if e is not None)
        assert torch.equal(torch.cat(pieces, dim=dim), full), path
        assert all(p.untyped_storage().data_ptr() != full.untyped_storage().data_ptr()
                   for p in pieces), path


def test_check_local_shards_refuses_split_heads():
    """Only what cannot run is refused: paged K/V pools whose kv heads the
    axis does not split (starcoder2's 4 over 3 ranks), with the JAX
    package's message.  Hymba's 25 heads over 5 kv heads split 2 ways into
    no whole heads: each rank holds the whole attention (its SWA rings
    keep every kv head) and the check passes."""
    cfg = C.get_config("hymba-1.5b")
    mesh = abstract_mesh((1, 2), ("data", "model"))
    shapes = _shapes(_param_shapes("hymba-1.5b"))
    placed = SH.serve_placement(cfg, mesh, shapes)
    SH.check_local_shards(cfg, mesh, placed)
    attn = [spec for path, spec in _flat(placed) if path[-1] in ("wq", "wk", "wv", "wo")]
    assert attn and all(all(e is None for e in spec) for spec in attn)
    sc = C.get_config("starcoder2-7b")
    mesh3 = abstract_mesh((1, 3), ("data", "model"))
    with pytest.raises(ValueError, match="n_kv_heads=4 is not divisible"):
        SH.check_local_shards(sc, mesh3, SH.serve_placement(
            sc, mesh3, _shapes(_param_shapes("starcoder2-7b"))))
    SH.check_local_shards(sc, mesh, SH.serve_placement(
        sc, mesh, _shapes(_param_shapes("starcoder2-7b"))))


@pytest.mark.parametrize("whole_vocab", [False, True])
@pytest.mark.parametrize("arch", ["starcoder2-7b", "granite-moe-3b-a800m", "deepseek-v3-671b"])
def test_a_ranks_shards_outside_a_policy_raise(arch, whole_vocab):
    """A rank's shards run outside an engine's shard policy raise instead of
    giving a whole model's wrong numbers: at the vocab-sharded embedding,
    and, with the embedding and head whole, at the first split heads or
    experts.  Inside a policy of one rank they still raise."""
    from repro_torch.distributed import axes as AX

    _, cfg = _smoke(arch)
    mesh = abstract_mesh((1, 2), ("data", "model"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with mock.patch.object(SH, "mesh_coords", lambda _m: {"data": 0, "model": 1}):
        shards = SH.shard_params(cfg, params, mesh, torch.device("cpu"))
    if whole_vocab:
        shards["embed"] = params["embed"]
        if "lm_head" in params:
            shards["lm_head"] = params["lm_head"]
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    what = "heads|experts|hidden" if whole_vocab else "embed's vocab rows"
    with pytest.raises(RuntimeError, match=f"({what}).*no shard policy"):
        M.prefill(cfg, shards, batch)
    one = AX.ShardPolicy(group=None, tp_rank=0, tp_size=1)
    with AX.policy(one), pytest.raises(RuntimeError, match="no shard policy"):
        M.prefill(cfg, shards, batch)
    M.prefill(cfg, params, batch)  # the whole tree runs without a policy


# --------------------------------------------------------------------------
# Serving on a data x model mesh: the serve layout
# --------------------------------------------------------------------------

SERVE_MESHES = {"2x2": (2, 2), "2x4": (2, 4), "16x16": (16, 16)}


def _jax_shard_shape(shape, spec, sizes):
    """A leaf's shard shape under a JAX spec: each dim over the product of
    the sizes of the axes its entry names (a NamedSharding's even split)."""
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if e is None else e if isinstance(e, tuple) else (e,)
        k = 1
        for a in axes:
            k *= sizes[a]
        assert n % k == 0
        out.append(n // k)
    return tuple(out)


@pytest.mark.parametrize("mesh_name", list(SERVE_MESHES))
@pytest.mark.parametrize("arch", C.arch_ids())
def test_serve_layout_stores_the_jax_serve_share(arch, mesh_name):
    """On a D x M mesh each stored leaf has the shard shape of the JAX
    serve spec, except the leaves kept whole: wq_a, an attention whose heads
    the model axis does not split whole, and those the base rules over the
    model axis replicate (norms, routers, SSM leaves, position tables),
    which the serve mode shards only by its 2-D fallback or ZeRO.  A dim
    split over both axes is stored model-major: the blocks of the D ranks
    of model slice m, in data order, are the 1 x M rank m's slice."""
    d, m = SERVE_MESHES[mesh_name]
    jmesh = j_abstract_mesh((d, m), ("data", "model"))
    mesh = abstract_mesh((d, m), ("data", "model"))
    jcfg, cfg = JC.get_config(arch), C.get_config(arch)
    shapes = _param_shapes(arch)
    jspecs = dict(_flat(_entries(JSH.param_pspecs(jcfg, jmesh, shapes, mode="serve"))))
    full = dict(_flat(_shapes(shapes)))
    sizes = {"data": d, "model": m}
    layout = SH.ServeLayout(cfg, mesh)
    tp = abstract_mesh((1, m), ("data", "model"))
    one_by_m = dict(_flat(SH.serve_placement(cfg, tp, _shapes(shapes))))
    stored = dict(_flat(SH.serve_placement(cfg, mesh, _shapes(shapes))))
    kept, flat = [], 0
    for path, shape in full.items():
        local = layout.local_shape(path, shape)
        if layout.kept_whole(path):
            assert local == shape, path
            stacked = any(s.startswith("seg") or s in ("encoder", "cross") for s in path)
            base = JSH._base_tp_spec(path[-1], shape, "model", m, stacked, jcfg)
            assert path[-1] in SH.whole_leaves(cfg, m) or all(e is None for e in base), path
            kept.append(path)
            continue
        assert local == _jax_shard_shape(shape, jspecs[path], sizes), (path, jspecs[path])
        for dim, e in enumerate(stored[path]):
            if not (isinstance(e, tuple) and set(e) == {"data", "model"}):
                continue
            flat += 1
            assert e == ("model", "data"), path  # model-major
            for mm in range(m):
                want = SH.shard_index(shape, one_by_m[path], tp, {"data": 0, "model": mm})
                got = [SH.shard_index(shape, stored[path], mesh, {"data": dd, "model": mm})[dim]
                       for dd in range(d)]
                assert got[0].start == want[dim].start and got[-1].stop == want[dim].stop
                assert all(a.stop == b.start for a, b in zip(got, got[1:])), path
    assert flat  # every arch keeps some weights split over both axes
    if any(p[-1] == "wq_a" for p in full):
        assert any(p[-1] == "wq_a" for p in kept)


@pytest.mark.parametrize("arch", C.arch_ids())
def test_serve_draw_by_shards_is_the_full_draws_slices(arch):
    """Every rank of an abstract 2 x 2 mesh draws its shares from the seed
    (``init_params(layout=ServeLayout)``): each bit-equal to the same slice
    of the full draw (``ServeLayout.place``), the serve spec's share of
    bytes; ``place`` keeps a placed tree as it is and refuses a tree of
    neither shape."""
    _, cfg = _smoke(arch)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    full = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for d in range(2):
        for m in range(2):
            coords = {"data": d, "model": m}
            layout = SH.ServeLayout(cfg, mesh, coords)
            mine = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                 layout=layout)
            cut = SH.ServeLayout(cfg, mesh, coords).place(full, torch.device("cpu"))
            for (path, a), (_, b) in zip(_flat(mine), _flat(cut)):
                assert torch.equal(a, b), path
            nbytes = sum(t.numel() * t.element_size() for _, t in _flat(mine))
            assert nbytes == layout.share_nbytes(mine)
            kept = layout.place(mine, torch.device("cpu"))
            assert all(a is b for (_, a), (_, b) in zip(_flat(kept), _flat(mine)))
    bad = dict(full, embed=full["embed"][:3])
    with pytest.raises(ValueError, match="neither the full leaf"):
        SH.ServeLayout(cfg, mesh).place(bad, torch.device("cpu"))


def test_serve_layout_plans_gathers_only_where_the_model_cannot_read():
    """The leaves a serving rank reads as stored: split over both axes (the
    1-D rule), or as the 1 x M port holds them.  starcoder2's smoke FFN at
    a hidden width of 42 on 2 x 2 takes the 2-D fallback: w_up and b_up
    gathered over data into the model slice, w_down gathered whole and cut
    (rows over data, columns over model, where the 1 x M port splits rows);
    nothing is gathered at 1 x M."""
    import dataclasses

    from repro_torch.distributed.axes import LeafUse

    cfg = dataclasses.replace(C.get_config("starcoder2-7b", smoke=True), d_ff=42)
    shapes = M.param_shapes(cfg)
    for spec, want in (((1, 2), {}), ((2, 2), {
            ("seg0", "ffn", "w_up"): LeafUse(data_dim=1),
            ("seg0", "ffn", "b_up"): LeafUse(data_dim=0),
            ("seg0", "ffn", "w_down"): LeafUse(1, 2, 1)})):
        layout = SH.ServeLayout(cfg, abstract_mesh(spec, ("data", "model")))
        for path, shape in _flat(shapes):
            layout.local_shape(path, shape)
        assert dict(_flat(layout.plan())) == want
