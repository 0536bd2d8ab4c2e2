"""The port's training path against the JAX package's, on the CPU.

For every architecture's smoke config, in fp32, on the JAX package's
weights (``params_from_numpy``) and the same batch from a numpy seed (a
vision batch on Qwen2-VL's image grid, three different position streams;
an audio batch with random audio): ``forward_train``'s logits within 1e-4,
``loss_fn``'s loss and its ``ce``, ``aux`` and ``mtp`` metrics within 1e-5
relative, and every gradient leaf within 1e-4 of that leaf's largest
|g| of ``jax.grad``, with the port's ``remat`` on and off.  In bf16 a dense
and a MoE stack within the suite's 2e-2.  Then AdamW over three steps from
the same gradients (1e-6), the global-norm clip and both schedules; the
``gemm_backend`` kernel routes (their plain versions here) against the xla
route, and their refusal under autograd.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as JC
import repro.optim as JO
import repro_torch.configs as TC
import repro_torch.kernels as tk
import repro_torch.optim as TO
from repro.models import model as JM
from repro_torch import tree as T
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import model as TM

GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
BF16_TOL = 2e-2


def _batch(cfg, seed=1, B=2, S=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg.frontend == "vision":
        n = cfg.n_frontend_tokens
        b["vis_embeds"] = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        i = np.arange(n)  # the image grid, then text from one past it
        img = np.stack([np.zeros(n), i // 4, i % 4])
        text = np.broadcast_to(img.max() + 1 + np.arange(S - n), (3, S - n))
        p = np.concatenate([img, text], 1).astype(np.int32)
        b["positions3"] = np.ascontiguousarray(np.broadcast_to(p[:, None], (3, B, S)))
    if cfg.frontend == "audio":
        b["audio_embeds"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return b


def _setup(arch, jdtype, tdtype):
    jc = JC.get_config(arch, smoke=True, dtype=jdtype)
    tc = TC.get_config(arch, smoke=True, dtype=tdtype)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    nb = _batch(jc)
    jb = {k: jnp.asarray(v, jdtype) if k.endswith("_embeds") else jnp.asarray(v)
          for k, v in nb.items()}
    tb = {k: torch.from_numpy(v).to(tdtype) if k.endswith("_embeds") else torch.from_numpy(v)
          for k, v in nb.items()}
    return jc, tc, jp, tp, jb, tb


_JAX = {}


def _reference(arch):
    """The JAX side of ``arch`` in fp32, computed once: logits, aux, loss,
    metrics and gradients."""
    if arch not in _JAX:
        jc, tc, jp, tp, jb, tb = _setup(arch, jnp.float32, torch.float32)

        def both(p):  # one compile for the forward and the gradient
            logits, aux, _ = JM.forward_train(jc, p, jb, remat=False)
            return (logits, aux), jax.value_and_grad(
                lambda q: JM.loss_fn(jc, q, jb, remat=False), has_aux=True)(p)

        (logits, aux), ((loss, metrics), grads) = jax.jit(both)(jp)
        _JAX[arch] = (tc, tp, tb, np.asarray(logits), float(aux), float(loss),
                      {k: float(v) for k, v in metrics.items()},
                      [np.asarray(g) for g in jax.tree.leaves(grads)])
    return _JAX[arch]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_errors(got, want):
    """Each leaf's max |g_port - g_jax| over that leaf's max |g_jax|."""
    out = []
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        out.append(float(np.abs(g.float().numpy() - w.astype(np.float32)).max())
                   / max(scale, 1e-30))
    return out


ARCHS = list(TC.arch_ids())
assert ARCHS == list(JC.arch_ids())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    tc, tp, tb, logits, aux, *_ = _reference(arch)
    with torch.no_grad():
        got, got_aux, h = TM.forward_train(tc, tp, tb, remat=False)
    assert got.shape == logits.shape and h.shape[:2] == logits.shape[:2]
    assert float(np.abs(got.numpy() - logits).max()) <= 1e-4
    assert _rel(float(got_aux), aux) <= LOSS_RTOL or abs(float(got_aux) - aux) <= 1e-12


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    tc, tp, tb, _, _, loss, metrics, _ = _reference(arch)
    with torch.no_grad():
        got, got_m = TM.loss_fn(tc, tp, tb)
    assert set(got_m) == set(metrics)
    assert _rel(float(got), loss) <= LOSS_RTOL
    for k, v in metrics.items():
        assert _rel(float(got_m[k]), v) <= LOSS_RTOL or abs(float(got_m[k]) - v) <= 1e-12, k


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch, remat):
    tc, tp, tb, _, _, loss, _, grads = _reference(arch)
    got_loss, _, got = loss_and_grads(tc, tp, tb, remat=remat)
    assert _rel(float(got_loss), loss) <= LOSS_RTOL
    assert len(got) == len(grads)  # the JAX package's leaf order
    errs = _leaf_errors(got, grads)
    worst = max(range(len(errs)), key=errs.__getitem__)
    assert errs[worst] <= GRAD_TOL, (T.paths(tp)[worst], errs[worst])
    assert all(n == 0 for n in tk.launch_counts().values())


@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-3b-a800m"])
def test_bf16_loss_and_gradients_match_jax(arch):
    jc, tc, jp, tp, jb, tb = _setup(arch, jnp.bfloat16, torch.bfloat16)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jc, p, jb, remat=False), has_aux=True))(jp)
    got_loss, got_m, got = loss_and_grads(tc, tp, tb)
    assert _rel(float(got_loss), float(loss)) <= BF16_TOL
    want_aux = float(metrics["aux"])  # 0 for the dense stack
    assert abs(float(got_m["aux"]) - want_aux) <= BF16_TOL * max(want_aux, 1e-3)
    errs = _leaf_errors(got, [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)])
    assert max(errs) <= BF16_TOL, max(errs)
    # each gradient in its parameter's type (a MoE router stays fp32)
    assert [g.dtype for g in got] == [p.dtype for p in T.leaves(tp)]


@pytest.mark.parametrize("masked", ["some", "all"])
def test_cross_entropy_masks_negative_labels_like_jax(masked):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    labels[:, ::2] = -1
    if masked == "all":
        labels[:] = -1  # no position counts: the sum over max(0, 1)
    got = float(TM.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    want = float(JM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)
    if masked == "all":
        assert got == 0.0


def _tiny(**over):
    kw = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
              vocab_size=128, block=16)
    kw.update(over)
    return (JC.get_config("minicpm-2b", smoke=True, dtype=jnp.float32, **kw),
            TC.get_config("minicpm-2b", smoke=True, dtype=torch.float32, **kw))


def test_gemm_backend_bwma_matches_xla():
    """``tests/test_models.py::test_gemm_backend_bwma_matches_xla`` on the
    port's routes (the kernels' plain versions on the CPU), forward only."""
    jc, tc = _tiny()
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, JM.init_params(jc, jax.random.PRNGKey(0))),
                              device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    with torch.no_grad():
        lx, _, _ = TM.forward_train(tc, tp, batch, remat=False)
        for backend in ("bwma", "rwma"):
            lb, _, _ = TM.forward_train(dataclasses.replace(tc, gemm_backend=backend), tp,
                                        batch, remat=False)
            np.testing.assert_allclose(lb.numpy(), lx.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("backend", ["bwma", "rwma"])
def test_kernel_routes_refuse_autograd(backend):
    """A kernel launched through ctypes has no backward: with grad mode on,
    the routes raise, on the CPU too, instead of training without those
    weights' gradients."""
    _, tc = _tiny(gemm_backend=backend)
    tp = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((2, 16), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(RuntimeError, match="no backward"):
        loss_and_grads(tc, tp, batch)
    with torch.no_grad():  # serving: nothing requires a gradient
        TM.forward_train(tc, tp, batch, remat=False)
    a = torch.randn(2, 2, 8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="bwma_gemm: the hand-written kernels have no"):
        tk.bwma_gemm(a, torch.randn(2, 2, 8, 8))
    with torch.no_grad():
        tk.bwma_gemm(a, torch.randn(2, 2, 8, 8))
    with pytest.raises(RuntimeError, match="bwma_softmax"):
        tk.bwma_softmax(torch.randn(2, 2, 8, 8, requires_grad=True), n_logical=16)


# --------------------------------------------------------------------------
# AdamW and the schedules
# --------------------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": {"x": rng.standard_normal((8,)).astype(np.float32),
                  "y": rng.standard_normal((3, 5)).astype(np.float32) * 1e-3}}


@pytest.mark.parametrize("donate", [False, True], ids=["functional", "donate"])
def test_adamw_update_matches_jax(donate):
    oc_j, oc_t = JO.OptConfig(lr=1e-2), TO.OptConfig(lr=1e-2)
    params = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = T.tree_map(torch.from_numpy, params)
    jopt, topt = JO.adamw_init(jp, oc_j), TO.adamw_init(tp, oc_t)
    lr_j = JO.cosine_schedule(1e-2, 1, 10)
    lr_t = TO.cosine_schedule(1e-2, 1, 10)
    for step in range(3):
        g = _opt_tree(10 + step)
        g = {**g, "w": g["w"] * 50.0}  # a global norm above the clip
        jp, jopt = JO.adamw_update(jax.tree.map(jnp.asarray, g), jopt, jp, oc_j,
                                   lr_j(jopt["step"]))
        tp, topt = TO.adamw_update(T.tree_map(torch.from_numpy, g), topt, tp, oc_t,
                                   lr_t(topt["step"]), donate=donate)
    assert int(topt["step"]) == int(jopt["step"]) == 3 and topt["step"].dtype == torch.int32
    for got, want in zip(T.leaves((tp, topt["m"], topt["v"])),
                         jax.tree.leaves((jp, jopt["m"], jopt["v"]))):
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-6


def test_adamw_bf16_params_keep_fp32_moments():
    tp = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    opt = TO.adamw_init(tp)
    assert opt["m"]["w"].dtype == torch.float32
    new, opt = TO.adamw_update({"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}, opt,
                               tp, TO.OptConfig(), 1e-2)
    assert new["w"].dtype == torch.bfloat16 and opt["v"]["w"].dtype == torch.float32
    assert float(new["w"][0, 0]) < 1.0


@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _opt_tree(3)
    jg, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = TO.clip_by_global_norm(T.tree_map(torch.from_numpy, g), max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for a, b in zip(T.leaves(tg), jax.tree.leaves(jg)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-7


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_jax(name):
    if name == "cosine":
        jf, tf = JO.cosine_schedule(3e-4, 10, 100), TO.cosine_schedule(3e-4, 10, 100)
    else:
        jf, tf = JO.wsd_schedule(1e-3, 10, 60, 20), TO.wsd_schedule(1e-3, 10, 60, 20)
    for step in range(0, 110, 3):
        want = float(jf(step))
        assert abs(float(tf(step)) - want) <= 1e-6 * max(want, 1e-3), step
        assert abs(float(tf(torch.tensor(step, dtype=torch.int32))) - want) <= 1e-6 * max(
            want, 1e-3)
