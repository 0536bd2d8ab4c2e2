"""One rank of the mesh cases of ``tests/test_torch_dryrun.py`` (gloo, on the
CPU).

    python tests/torch_dryrun_ranks.py STORE_FILE RANK WORLD SHAPE OUT_DIR

``SHAPE`` is ``DxM`` (a ``("data", "model")`` mesh) or ``PxDxM`` (``("pod",
"data", "model")``).  Each rank joins a ``gloo`` group through a
``FileStore``, builds the mesh, and for every case: draws the smoke
config's weights from seed 0 whole (the single-device reference) and by
shards as the dry run's decode stores them (``ServeLayout(exact=True)``),
fills a static cache with seeded numbers and position labels, cuts its
share of the cache (``cache_pspecs``) and of the tokens (``batch_pspecs``),
runs one decode step under ``decode_policy`` and compares the logits (every
row) and its share of the written cache with the single-device step on the
whole cache.  Then three Trainer steps and a prefill under the trainer's
placement, each against one device.  Writes ``OUT_DIR/rank{RANK}.pkl``.
Imports neither ``jax`` nor ``repro``.
"""
import copy
import datetime
import math
import pickle
import sys
import traceback
import unittest.mock as mock

import torch
import torch.distributed as dist

TIMEOUT_S = 60

# (arch, batch rows, cache slots, decode position)
CASES = [
    ("starcoder2-7b", 4, 16, 11),
    ("minicpm-2b", 4, 16, 5),
    ("qwen1.5-110b", 4, 16, 11),
    ("qwen2-vl-72b", 4, 16, 11),
    ("granite-moe-3b-a800m", 4, 16, 11),
    ("deepseek-v3-671b", 4, 16, 11),
    ("h2o-danube-3-4b", 4, 16, 13),
    ("hymba-1.5b", 4, 16, 13),
    ("mamba2-130m", 4, 16, 13),
    ("whisper-tiny", 4, 16, 11),
    # one row: the slots split over every axis (the long-context decode)
    ("h2o-danube-3-4b", 1, 32, 21),
    ("hymba-1.5b", 1, 32, 21),
    ("mamba2-130m", 1, 32, 21),
]

# training and prefill on the mesh against one device, the smoke models
# ZeRO-sharded (REPLICATE_BELOW patched to 0): (arch, batch rows, sequence)
TRAIN_CASES = [("minicpm-2b", 4, 16), ("granite-moe-3b-a800m", 4, 16)]
PREFILL_CASES = [("minicpm-2b", 4, 16), ("hymba-1.5b", 4, 16), ("whisper-tiny", 4, 16)]


def _filled_cache(cfg, B, S, pos, gen):
    """The static cache after ``pos`` tokens: seeded numbers, and each
    slot's position label (a ring's slot holds the latest position that
    maps to it; -1 where none has yet)."""
    from repro_torch.models import model as M

    cache = M.init_cache(cfg, B, S, device="cpu")

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "pos":
                slots = v.shape[-1]
                lab = torch.full((slots,), -1, dtype=v.dtype)
                for p in range(pos):
                    lab[p % slots] = p
                v.copy_(lab.expand_as(v))
            else:
                v.copy_(torch.randn(v.shape, generator=gen, dtype=torch.float32) * 0.5)

    fill(cache)
    return cache


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def run_case(arch, B, S, pos, mesh):
    import repro_torch.configs as C
    from repro_torch.distributed import axes as AX
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M

    cfg = C.get_config(arch, smoke=True, dtype=torch.float32)
    full = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    cache = _filled_cache(cfg, B, S, pos, gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, dtype=torch.int32)
    with torch.no_grad():
        want, want_cache = M.decode_step(cfg, full, copy.deepcopy(cache), tokens, pos)
    layout = SH.ServeLayout(cfg, mesh, exact=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", layout=layout)
    specs = SH.cache_pspecs(cfg, mesh, cache)
    mine = {p: SH.local_shard(t, SH._get(specs, p), mesh).clone() for p, t in _leaves(cache)}
    local_cache = M._rebuild(cache, mine)
    tok_spec = SH.batch_pspecs(cfg, mesh, {"tokens": tokens})["tokens"]
    local_tokens = SH.local_shard(tokens, tok_spec, mesh).clone()
    pol = layout.decode_policy(cache, local_tokens.shape[0], B)
    with torch.no_grad(), AX.policy(pol):
        got, got_cache = M.decode_step(cfg, params, local_cache, local_tokens, pos)
    cache_err = max(
        float((t - SH.local_shard(dict(_leaves(want_cache))[p], SH._get(specs, p), mesh))
              .abs().max()) for p, t in _leaves(got_cache))
    stored = sum(x.numel() * x.element_size() for _p, x in _leaves(params))
    jax_share = sum(math.prod(t.shape) * t.element_size()
                    // SH.split_ways(SH._get(SH.param_pspecs(cfg, mesh, full, mode="serve"), p),
                                     AX.mesh_shape(mesh))
                    for p, t in _leaves(full))
    return {"logits_err": float((got - want).abs().max()), "cache_err": cache_err,
            "scale": float(want.abs().max()), "rows": tuple(got.shape),
            "seq": None if pol.decode.seq is None else pol.decode.seq[:2],
            "row_split": pol.decode.rows is not None,
            "stored": stored, "jax_share": jax_share}


def _zero():
    from repro_torch.distributed import sharding as SH

    return mock.patch.object(SH, "REPLICATE_BELOW", 0)


def run_train(arch, B, S, mesh):
    """Three Trainer steps on the mesh and on one device: the losses and
    every parameter after them (gathered whole)."""
    import repro_torch.configs as C
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = C.get_config(arch, smoke=True, dtype=torch.float32)
    tc = TrainerConfig(steps=3, checkpoint_every=0, log_every=1)
    data = SyntheticLMData(cfg, global_batch=B, seq_len=S)
    ref_params, _o, want = Trainer(cfg, None, tc, OptConfig(lr=1e-2), device="cpu").fit(data)
    with _zero():
        tr = Trainer(cfg, mesh, tc, OptConfig(lr=1e-2), device="cpu")
        params, _opt, got = tr.fit(data)
        specs = tr.layout.specs(params)
        split = any(e is not None for _p, sp in _leaves(specs) for e in sp)
        mine = {p: SH.gather_full(x, SH._get(specs, p), mesh) for p, x in _leaves(params)}
    return {"loss_err": max(abs(a["loss"] - b["loss"]) for a, b in zip(got, want)),
            "param_err": max(float((mine[p] - x).abs().max()) for p, x in _leaves(ref_params)),
            "split": split}


def run_prefill(arch, B, S, mesh):
    """One prefill under the trainer's placement and policy (the dry run's
    prefill cells) against one device: the last position's logits."""
    import repro_torch.configs as C
    from repro_torch.distributed import axes as AX
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M

    cfg = C.get_config(arch, smoke=True, dtype=torch.float32)
    gen = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     dtype=torch.int32)}
    if cfg.frontend == "audio":
        batch["audio_embeds"] = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen)
    full = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        want, _ = M.prefill(cfg, full, batch)
    with _zero():
        layout = SH.TrainLayout(cfg, mesh)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                               layout=layout)
        bspecs = SH.batch_pspecs(cfg, mesh, batch)
        local = {k: SH.local_shard(v, bspecs[k], mesh).clone() for k, v in batch.items()}
        pol = layout.policy(rows_split=bspecs["tokens"][0] is not None)
        with torch.no_grad(), AX.policy(pol):
            got, _ = M.prefill(cfg, params, local)
        rows = SH.shard_index(tuple(want.shape), bspecs["tokens"][:1], mesh)[0]
    return {"logits_err": float((got - want[rows]).abs().max()),
            "scale": float(want.abs().max())}


def main():
    store_path, rank, world, shape, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from torch.distributed.device_mesh import DeviceMesh

    sizes = [int(x) for x in shape.split("x")]
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data", "model")
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(sizes), mesh_dim_names=names)
    out = {}
    runs = ([(f"decode-{a}-{b}x{s}", run_case, (a, b, s, p)) for a, b, s, p in CASES]
            + [(f"train-{c[0]}", run_train, c) for c in TRAIN_CASES]
            + [(f"prefill-{c[0]}", run_prefill, c) for c in PREFILL_CASES])
    for key, fn, args in runs:
        try:
            out[key] = fn(*args, mesh)
        except Exception:  # recorded: the test reports it
            out[key] = {"error": traceback.format_exc()[-3000:]}
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
