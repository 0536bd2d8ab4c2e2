"""One rank of the port's serving cases on a mesh (gloo, on the CPU).

``tests/test_torch_mesh_serve.py`` and ``tests/test_torch_mesh_serve_dp.py``
start ``world`` of these processes:

    python tests/torch_mesh_ranks.py CASES_PICKLE STORE_FILE RANK WORLD OUT_DIR [DxM]

Each joins a ``gloo`` group through a ``FileStore`` (with a timeout, so a
collective that hangs fails the rank), builds the ``DxM`` mesh (default
``1 x world``), runs every case of the pickle made for that mesh (its
``mesh``, else ``1 x`` its ``tp``) and writes its results to
``OUT_DIR/rank{RANK}.pkl``.  A case with ``draw="shards"`` draws the rank's
shares of the weights from seed 0 (``init_params(layout=)``) and gives the
engine that tree.  It imports neither ``jax`` nor ``repro``.
"""
import dataclasses
import datetime
import pickle
import sys
import traceback
import unittest.mock as mock

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 60


def build(case, mesh=None):
    import repro_torch.configs as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M

    cfg = dataclasses.replace(C.get_config(case["arch"], smoke=True, dtype=torch.float32),
                              **case["over"])
    if case.get("draw") == "shards":
        params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                               layout=SH.ServeLayout(cfg, mesh))
    elif case["params"] is None:
        params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    else:
        params = M.params_from_numpy(case["params"], device="cpu")
    return cfg, params


def run_engine(case, cfg, params, mesh):
    """The case's requests through ``Engine`` on ``mesh`` (None: one
    device); returns the engine, each request's tokens and the first decode
    step's logits."""
    from repro_torch.serve import Engine, EngineConfig

    eng = Engine(cfg, params, EngineConfig(**case["ec"]), mesh=mesh, device="cpu")
    first = []
    decode = eng._decode

    def recording(*args):
        out = decode(*args)
        if not first:
            first.append(out[1].float().numpy().copy())
        return out

    eng._decode = recording
    audio = case.get("audio")
    for i, p in enumerate(case["prompts"]):
        eng.submit(p, case["max_new"], rid=i, arrival_step=case["stagger"] * i,
                   extras=None if audio is None else {"audio_embeds": audio[i]})
    reqs = eng.run()
    assert all(r.state == "finished" for r in reqs)
    return eng, [np.asarray(r.out_tokens, np.int32) for r in reqs], first[0]


def run_case(case, mesh):
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server

    cfg, params = build(case, mesh)
    kind = case["kind"]
    if kind == "engine":
        eng, toks, logits = run_engine(case, cfg, params, mesh)
        layout = SH.ServeLayout(cfg, mesh)
        return {"tokens": toks, "first_logits": logits,
                "bytes_per_device": eng.kv.cache_bytes_per_device(),
                "bytes": eng.kv.cache_bytes(), "cow_copies": eng.kv.cow_copies,
                "pages_aliased": eng.kv.pages_aliased,
                "preemptions": sum(r.stats.n_preemptions
                                   for r in eng.sched.finished.values()),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for _p, t in SH.flat_items(eng.params)),
                "param_bytes_by_spec": layout.share_nbytes(eng.params),
                "placed_tree_kept": all(a is b for (_p, a), (_q, b) in zip(
                    SH.flat_items(eng.params), SH.flat_items(params))),
                "gathered": layout.gathered()}
    if kind == "server":
        batch = {"tokens": np.stack(case["prompts"])}
        out = Server(cfg, params, ServeConfig(max_len=64), mesh=mesh,
                     device="cpu").generate(batch, case["max_new"])
        return {"tokens": list(out)}
    if kind == "reject":
        # the refusal comes before the engine cuts a shard or a pool
        ec = EngineConfig(**case["ec"])
        with mock.patch.object(SH, "local_shard", side_effect=AssertionError("sharded")), \
                mock.patch.object(M, "init_paged_cache", side_effect=AssertionError("pool")):
            try:
                Engine(cfg, params, ec, mesh=mesh, device="cpu")
            except ValueError as e:
                return {"error": str(e)}
        return {"error": None}
    if kind == "data_axis":  # the world's ranks as the case's D x M mesh
        _eng, toks, _logits = run_engine(case, cfg, params, make_serve_mesh(case["serve_mesh"]))
        return {"tokens": toks}
    if kind == "constructs":
        eng = Engine(cfg, params, EngineConfig(**case["ec"]), mesh=mesh, device="cpu")
        return {"bytes_per_device": eng.kv.cache_bytes_per_device()}
    raise ValueError(kind)


def main(cases_path, store, rank, world, out_dir, spec=None):
    from repro_torch.launch.mesh import make_serve_mesh

    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    spec = spec or f"1x{world}"
    mesh = make_serve_mesh(spec)
    results = {}
    for case in cases:
        if (case.get("mesh") or f"1x{case['tp']}") != spec:
            continue
        try:
            results[case["name"]] = run_case(case, mesh)
        except Exception:  # the test reports it, with the rank's traceback
            results[case["name"]] = {"exception": traceback.format_exc()}
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], a[1], int(a[2]), int(a[3]), a[4], *a[5:])
