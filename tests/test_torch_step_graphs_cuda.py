"""The chunk step's and the static Server's CUDA graphs on the card (``serve/graphs.py``).

Each case runs only on an sm_90 card (marked ``cuda``, skipped elsewhere;
run with ``--noconftest``: ``tests/conftest.py`` imports jax).  The port's
starcoder2-7b smoke config in fp32, pages of 8, random weights from a
seed:

* after an engine's run, its chunk runners replayed in the reverse of their
  capture order, each bit-identical to the eager chunk step on a clone of
  the pool, and every chunk of the run likewise (but the null page, where a
  shape's first call's warm-up writes);
* the static ``Server``'s waves of 2, 1 and 2 requests: every prefill and
  decode replay bit-identical to the eager step, one capture a shape;
* a ``Server`` meeting twice ``MAX_PREFILL_SHAPES`` prompt lengths keeps
  that many prefill runners and no more memory in use than after the
  first half;
* a chunk step with an injected ``.item()`` makes the capture raise after
  the warm-up, and no call follows (last: a failed capture may leave the
  process's capture state behind).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro_torch.configs as TC
from repro_torch import tree as T
from repro_torch.models import model as TM
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server
from repro_torch.serve.engine import MAX_PREFILL_SHAPES, chunk_shape_set, step_fns
from repro_torch.serve.graphs import WARMUP_STEPS, ChunkGraph

PAGE = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(card):
    cfg = dataclasses.replace(TC.get_config("starcoder2-7b", smoke=True, dtype=torch.float32),
                              block=PAGE)
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0), device=card)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 14, 6, 11, 3)]
    return cfg, params, prompts


def _eager_chunk(eng, runner, pool):
    step = step_fns(eng.cfg)["prefill_chunk"][0]
    row = runner.mirror.index_select(0, runner.slot.reshape(1))[0].clone()
    with torch.no_grad():
        return step(eng.params, pool, runner.tokens.clone(), runner.slot.clone(),
                    runner.q_off.clone(), runner.phys_tok.clone(), runner.off_tok.clone(),
                    row, runner.last_idx.clone())


def _equal_trees(a, b, skip_null=False):
    """Every leaf bit-identical; with ``skip_null``, page 0 of the paged
    pools (axis 1) left out, where a first call's warm-up writes."""
    return all(torch.equal(x[:, 1:], y[:, 1:]) if skip_null and "pages" in name
               else torch.equal(x, y)
               for (name, x), (_, y) in zip(_named(a), _named(b)))


def _slots_equal(full, small):
    """A prefill's cache tree ``small`` bit-identical to the first slots of
    the wave's tree ``full``, where the Server's prefill writes it."""
    return all(torch.equal(full[seg][key][name][tuple(slice(0, n) for n in leaf.shape)], leaf)
               for seg, sub in small.items() for key, leaves in sub.items()
               for name, leaf in leaves.items())


def _named(tree):
    """(leaf name, leaf) of a (segment -> key -> name) tree, in its order."""
    return [(name, leaf) for sub in tree.values() for leaves in sub.values()
            for name, leaf in leaves.items()]


@pytest.mark.cuda
def test_chunk_replays_in_another_order_equal_the_eager_chunk(card):
    cfg, params, prompts = _setup(card)
    eng = Engine(cfg, params, EngineConfig(max_seqs=2, max_len=32, page_size=PAGE),
                 device=card)
    for i, p in enumerate(prompts):
        eng.submit(p, 4, rid=i, arrival_step=i)
    real, order, differ = eng._chunk, [], []

    def checked(params, pool, toks, slot, off, phys, offs, last):
        before = T.tree_map(lambda t: t.clone(), pool)
        logits, pool = real(params, pool, toks, slot, off, phys, offs, last)
        want_l, want_pool = _eager_chunk(eng, eng._chunk_graphs[toks.shape[1]], before)
        order.append(toks.shape[1])
        if not (torch.equal(logits, want_l) and _equal_trees(pool, want_pool, True)):
            differ.append(len(order))
        return logits, pool

    eng._chunk = checked
    eng.run()
    runners = eng._chunk_graphs
    assert not differ and len(order) == eng.prefill_chunks
    assert len(runners) > 1 and set(runners) == set(order)
    assert set(runners) <= set(chunk_shape_set(cfg, eng.chunk_size))
    assert all(r.captures == 1 for r in runners.values())
    rng = np.random.default_rng(5)
    for n in reversed(list(runners)):  # the reverse of the capture order
        runner = runners[n]
        toks = rng.integers(0, cfg.vocab_size, size=(1, n)).astype(np.int32)
        before = T.tree_map(lambda t: t.clone(), eng.kv.data)
        logits, _ = runner(eng.params, eng.kv.data, toks, 1, 0, np.zeros(n, np.int32),
                           np.arange(n, dtype=np.int32), n - 1)
        want_l, want_pool = _eager_chunk(eng, runner, before)
        assert torch.equal(logits, want_l) and _equal_trees(eng.kv.data, want_pool), n
        assert runner.captures == 1


@pytest.mark.cuda
def test_server_replays_equal_the_eager_steps(card):
    cfg, params, prompts = _setup(card)
    srv = Server(cfg, params, ServeConfig(max_len=24), device=card)
    real_prefill, real_decode = srv._prefill, srv._decode
    differ = []

    def prefill(params, batch, caches, last_idx=None):
        logits = real_prefill(params, batch, caches, last_idx)
        li = None if last_idx is None else torch.tensor(last_idx, dtype=torch.int32,
                                                         device=card)
        with torch.no_grad():
            want_l, want_c = TM.prefill(cfg, params, batch, li)
        if not (torch.equal(logits, want_l) and _slots_equal(caches, want_c)):
            differ.append(("prefill", batch["tokens"].shape))
        return logits

    def decode(params, caches, tokens, pos):
        before = T.tree_map(lambda t: t.clone(), caches)
        logits, caches = real_decode(params, caches, tokens, pos)
        with torch.no_grad():
            want_l, want_c = TM.decode_step(cfg, params, before, tokens.clone(),
                                            torch.tensor(pos, dtype=torch.int32, device=card))
        if not (torch.equal(logits, want_l) and _equal_trees(caches, want_c)):
            differ.append(("decode", pos))
        return logits, caches

    srv._prefill, srv._decode = prefill, decode
    two = {"tokens": np.stack([prompts[0], prompts[3][:9]])}
    one = {"tokens": prompts[1][None]}
    first = srv.generate(two, 5)
    srv.generate(one, 5)
    again = srv.generate(two, 5)
    assert not differ
    np.testing.assert_array_equal(again, first)
    assert set(srv._decode_graphs) == {1, 2} and len(srv._prefill_graphs) == 2
    assert all(g.captures == 1 for g in (*srv._decode_graphs.values(),
                                         *srv._prefill_graphs.values()))


@pytest.mark.cuda
def test_server_memory_stays_bounded_over_many_prompt_shapes(card):
    """The SWA ring prefills at the prompt's exact length, so each length
    is a new prompt shape: after one round of ``MAX_PREFILL_SHAPES``
    lengths, a second round of as many other lengths leaves as many runners
    and no more memory in use (a runner keeps its input buffers and logits,
    the wave's tree the caches).  A 32k vocabulary makes each runner's
    logits 128 KiB, twice the allowed slack."""
    cfg = dataclasses.replace(TC.get_config("h2o-danube-3-4b", smoke=True, dtype=torch.float32),
                              block=PAGE, vocab_size=32768)
    assert not TM.supports_padded_prefill(cfg)
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0), device=card)
    srv = Server(cfg, params, ServeConfig(max_len=64), device=card)
    rng = np.random.default_rng(9)
    n = MAX_PREFILL_SHAPES

    def round_of(lengths):
        for s in lengths:
            srv.generate({"tokens": rng.integers(0, cfg.vocab_size, size=(1, s))
                          .astype(np.int32)}, 2)
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(card)

    first = round_of(range(4, 4 + 2 * n, 2))
    second = round_of(range(5, 5 + 2 * n, 2))
    assert len(srv._prefill_graphs) == n and len(srv._caches) == 1
    assert all(g.captures == 1 for g in srv._prefill_graphs.values())
    assert second <= first + 64 * 1024, (first, second)


@pytest.mark.cuda
def test_a_sync_inside_the_chunk_step_makes_the_capture_raise(card):
    cfg, params, _ = _setup(card)
    pool = TM.init_paged_cache(cfg, 2, 9, PAGE, 32, device=card)
    mirror = torch.zeros((2, 4), dtype=torch.int32, device=card)
    step = step_fns(cfg)["prefill_chunk"][0]
    calls = [0]

    def with_sync(*args):
        calls[0] += 1
        out = step(*args)
        if args[3].sum().item() < 0:  # a host sync inside the step
            raise AssertionError("unreachable")
        return out

    runner = ChunkGraph(with_sync, params, pool, mirror, PAGE, card)
    with pytest.raises(RuntimeError):
        runner(params, pool, np.zeros((1, PAGE), np.int32), 0, 0, np.zeros(PAGE, np.int32),
               np.arange(PAGE, dtype=np.int32), PAGE - 1)
    assert calls[0] == WARMUP_STEPS + 1
