"""One rank of the port's training-mesh cases (gloo, on the CPU).

``tests/test_torch_mesh_train.py`` starts ``D * M`` of these processes per
mesh shape:

    python tests/torch_mesh_train_ranks.py CASES_PICKLE STORE_FILE RANK D M OUT_DIR

Each joins a ``gloo`` group through a ``FileStore`` (with a timeout, so a
collective that hangs fails the rank), builds the ``D x M`` mesh, runs every
case of the pickle whose ``mesh`` is ``"DxM"`` in order and writes its
results to ``OUT_DIR/rank{RANK}.pkl``.  It imports neither ``jax`` nor
``repro``.
"""
import contextlib
import datetime
import os
import pickle
import sys
import time
import traceback
import unittest.mock as mock

import torch
import torch.distributed as dist

TIMEOUT_S = 60


def build_cfg(case):
    import repro_torch.configs as C

    return C.get_config(case["arch"], smoke=True, dtype=torch.float32, **case["over"])


def _zero(case):
    """REPLICATE_BELOW patched to 0 (TP + ZeRO on a smoke model), or not."""
    from repro_torch.distributed import sharding as SH

    if case.get("zero"):
        return mock.patch.object(SH, "REPLICATE_BELOW", 0)
    return contextlib.nullcontext()


def _flat(tree):
    from repro_torch.distributed.sharding import flat_items

    return flat_items(tree)


def _gathered(tree, specs, mesh):
    """Every leaf gathered whole (a collective), as numpy on rank 0."""
    from repro_torch.distributed.sharding import gather_full

    out = {}
    for (path, leaf), (_p, spec) in zip(_flat(tree), _flat(specs)):
        full = gather_full(leaf.detach(), spec, mesh)
        if dist.get_rank() == 0:
            out[path] = full.numpy().copy()
    return out


def run_trainer(case, mesh):
    from repro_torch.data import SyntheticLMData
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = build_cfg(case)
    with _zero(case):
        tc = TrainerConfig(steps=case["steps"], checkpoint_every=0, log_every=1,
                           checkpoint_dir=case["ckpt"], accum_steps=case.get("accum", 1),
                           grad_compression=case.get("int8"))
        tr = Trainer(cfg, mesh, tc, OptConfig(lr=case["lr"]), device="cpu")
        params, opt, hist = tr.fit(SyntheticLMData(cfg, global_batch=case["batch"],
                                                   seq_len=case["seq"]))
        specs = tr.layout.specs(params)
        out = {"history": [h["loss"] for h in hist],
               "coords": dict(zip(("data", "model"), mesh.get_coordinate())),
               "specs": dict(_flat(specs)),
               "stored": {path: tuple(x.shape) for path, x in _flat(params)},
               "stored_m": {path: tuple(x.shape) for path, x in _flat(opt["m"])},
               "stored_v": {path: tuple(x.shape) for path, x in _flat(opt["v"])},
               "bytes": tr.layout.nbytes(params), "bytes_m": tr.layout.nbytes(opt["m"]),
               "params": _gathered(params, specs, mesh),
               "m": _gathered(opt["m"], specs, mesh)}
    return out


def run_draw(case, mesh):
    from repro_torch.distributed.sharding import TrainLayout
    from repro_torch.models import model as M

    cfg = build_cfg(case)
    with _zero(case):
        layout = TrainLayout(cfg, mesh)
        params = M.init_params(cfg, torch.Generator().manual_seed(case["seed"]),
                               device="cpu", layout=layout)
        return {"coords": dict(zip(("data", "model"), mesh.get_coordinate())),
                "specs": dict(_flat(layout.specs(params))),
                "shards": {path: x.numpy().copy() for path, x in _flat(params)}}


def run_restore(case, mesh):
    """Restore another mesh's checkpoint (waiting for it to be written):
    this rank's slices of the parameters and moments."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import TrainLayout
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init

    final = os.path.join(case["ckpt"], f"step_{case['step']:08d}")
    deadline = time.monotonic() + case["wait_s"]
    while not os.path.isdir(final):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{final} was not written")
        time.sleep(0.2)
    cfg = build_cfg(case)
    with _zero(case):
        layout = TrainLayout(cfg, mesh)
        params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                               layout=layout)
        state = (params, adamw_init(params))
        step, (p, o) = CheckpointManager(case["ckpt"]).restore(
            state, step=case["step"], device="cpu", shardings=layout.shardings(state))
        return {"step": step, "coords": dict(zip(("data", "model"), mesh.get_coordinate())),
                "specs": dict(_flat(layout.specs(p))),
                "params": {path: x.numpy().copy() for path, x in _flat(p)},
                "m": {path: x.numpy().copy() for path, x in _flat(o["m"])},
                "opt_step": int(o["step"])}


def run_compressed(case, mesh):
    from repro_torch.train.compression import compressed_psum

    n = case["ranks"]
    group = dist.group.WORLD
    if n != dist.get_world_size():
        group = dist.new_group(list(range(n)))  # every rank makes it
    if dist.get_rank() >= n:
        return {"out": None}
    grads = [torch.from_numpy(g[dist.get_rank()]) for g in case["grads"]]
    return {"out": [x.numpy() for x in compressed_psum(grads, group)]}


def run_batch(case, mesh):
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import sharding as SH

    cfg = build_cfg(case)
    data = SyntheticLMData(cfg, global_batch=case["batch"], seq_len=case["seq"], seed=2)
    specs = SH.batch_pspecs(cfg, mesh, data.shapes())
    shardings = {k: SH.Sharding(mesh, v) for k, v in specs.items()}
    out = {"specs": specs, "coords": dict(zip(("data", "model"), mesh.get_coordinate()))}
    for step in case["steps"]:
        b = data.batch(step, shardings=shardings)
        out[step] = {k: (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
                     for k, v in b.items()}
    return out


def run_moe(case, mesh):
    """moe_forward on this rank's rows under a training policy over
    ``data``: its output rows, its share of the aux loss and the gradients
    of a fixed function of both (x's rows, the router's share)."""
    from repro_torch.distributed import axes as AX
    from repro_torch.models import ffn

    cfg = build_cfg(case)
    p = {k: torch.from_numpy(v) for k, v in case["moe_params"].items()}
    x_all, w_all = torch.from_numpy(case["x"]), torch.from_numpy(case["w"])
    d_rank = mesh.get_coordinate()[0]
    b = x_all.shape[0] // mesh.shape[0]
    rows = slice(d_rank * b, (d_rank + 1) * b)
    x = x_all[rows].clone().requires_grad_(True)
    router = p["router"].clone().requires_grad_(True)
    pol = AX.make_train_policy(mesh, {}, rows_split=True)
    with AX.policy(pol):
        out, aux = ffn.moe_forward(dict(p, router=router), cfg, x)
        share = (out * w_all[rows]).sum() + aux  # the rank's share of the objective
        gx, gr = torch.autograd.grad(share, [x, router])
    return {"rows": (rows.start, rows.stop), "out": out.detach().numpy(),
            "aux": float(aux), "gx": gx.numpy(), "grouter": gr.numpy()}


RUNNERS = {"trainer": run_trainer, "draw": run_draw, "restore": run_restore,
           "compressed": run_compressed, "batch": run_batch, "moe": run_moe}


def main(cases_path, store, rank, d, m, out_dir):
    from repro_torch.launch.mesh import make_mesh

    world = d * m
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    mesh = make_mesh(f"{d}x{m}")
    results = {}
    for case in cases:
        if case["mesh"] != f"{d}x{m}":
            continue
        try:
            results[case["name"]] = RUNNERS[case["kind"]](case, mesh)
        except Exception:  # the test reports it, with the rank's traceback
            results[case["name"]] = {"exception": traceback.format_exc()}
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], a[1], int(a[2]), int(a[3]), int(a[4]), a[5])
