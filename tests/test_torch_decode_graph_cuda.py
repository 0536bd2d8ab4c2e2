"""The decode step's CUDA graph on the card (``serve/graphs.py``).

Each case runs only on an sm_90 card (marked ``cuda``, skipped elsewhere;
run with ``--noconftest``: ``tests/conftest.py`` imports jax).  The port's
smoke configs in fp32, random weights from a seed:

* two engines of different ``max_seqs`` stepped in turns (the second
  captures larger workspaces of the paged decode kernel): each one's greedy
  tokens equal an engine's run alone, and the workspaces each runner
  captured keep their storage;
* the counters read the decode kernel once a layer and a step after a run,
  the warm-up's and the capture's launches kept apart;
* a step with an injected ``.item()`` makes the capture raise after the
  warm-up, and no call follows.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro_torch.configs as TC
import repro_torch.kernels as tk
from repro_torch.models import model as TM
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve.engine import step_fns
from repro_torch.serve.graphs import WARMUP_STEPS, DecodeGraph

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
               for n in (9, 14, 6, 11)]
    return cfg, params, prompts


def _engine(cfg, params, prompts, slots, card):
    eng = Engine(cfg, params, EngineConfig(max_seqs=slots, max_len=48, page_size=PAGE),
                 device=card)
    for i, p in enumerate(prompts):
        eng.submit(p, 10, rid=i, arrival_step=i)
    return eng


@pytest.mark.cuda
def test_two_engines_in_turns_keep_their_captured_workspaces(card):
    cfg, params, prompts = _setup(card)
    alone = {slots: [r.out_tokens for r in _engine(cfg, params, prompts, slots, card).run()]
             for slots in (2, 4)}
    small = _engine(cfg, params, prompts, 2, card)
    large = _engine(cfg, params, prompts, 4, card)
    held = {id(e): {k: t.data_ptr() for k, t in e._decode._workspaces.items()}
            for e in (small, large)}
    assert all(held.values()) and small._decode.captures == large._decode.captures == 1
    while small.sched.has_work() or large.sched.has_work():
        for eng in (small, large):
            if eng.sched.has_work():
                eng.step()
    for eng in (small, large):
        eng._flush_pending()
    got = {e.ec.max_seqs: [e.sched.finished[r].out_tokens for r in sorted(e.sched.finished)]
           for e in (small, large)}
    assert got == alone
    for e in (small, large):
        assert {k: t.data_ptr() for k, t in e._decode._workspaces.items()} == held[id(e)]


@pytest.mark.cuda
def test_counters_read_what_the_card_ran(card):
    cfg, params, prompts = _setup(card)
    tk.reset_launch_counts()
    eng = _engine(cfg, params, prompts, 2, card)
    runner = eng._decode
    assert tk.launch_counts()["paged_attention_decode"] == 0
    assert runner.warmup_launches == {"paged_attention_decode": WARMUP_STEPS * cfg.n_layers}
    assert runner.replay_launches == {"paged_attention_decode": cfg.n_layers}
    eng.run()
    counts = tk.launch_counts()
    assert counts["paged_attention_decode"] == cfg.n_layers * eng.decode_steps
    assert {k for k, n in counts.items() if n} <= {"paged_attention_decode", "paged_copy"}


@pytest.mark.cuda
def test_a_sync_inside_the_step_makes_the_capture_raise(card):
    cfg, params, _ = _setup(card)
    pool = TM.init_paged_cache(cfg, 2, 9, PAGE, 32, device=card)
    step = step_fns(cfg)["decode_step"][0]
    calls = [0]

    def with_sync(*args):
        calls[0] += 1
        out = step(*args)
        if args[3].sum().item() < 0:  # a host sync inside the step
            raise AssertionError("unreachable")
        return out

    with pytest.raises(RuntimeError):
        DecodeGraph(with_sync, params, pool, 2, 4, card)
    assert calls[0] == WARMUP_STEPS + 1
