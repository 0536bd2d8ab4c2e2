# repro: noqa-file RPR005 -- CLI driver: the report prints ARE the output
"""Multi-pod dry run: trace one step of every (arch x shape x mesh) cell.

Counterpart of ``repro.launch.dryrun``.  For each cell this proves the
sharding rules and the port's runtime are coherent end to end: rank 0 of the
``16 x 16`` single-pod mesh (256 ranks) or the ``2 x 16 x 16`` multi-pod mesh
(512 ranks) places its shares of the parameters, the optimizer moments, the
batch and the caches on the ``meta`` device, then runs the step through
:func:`repro_torch.analysis.aot.trace_step` -- every operation and every
collective is issued, nothing is computed.  The process group is the
``fake`` backend of ``torch.distributed`` (a ``FakeStore``): 256 or 512
ranks with no peers, whose collectives return at once.  Each cell writes one
JSON record with the JAX record's fields: ``status``, ``n_devices``,
``memory`` (:data:`repro_torch.analysis.aot.MEMORY_FIELDS`), ``flops``
(per device, the whole step), ``collectives`` (bytes by kind and a count),
``params``, ``active_params``, ``accum_steps``; skip and error records as
the JAX package writes them.

Placement, as the JAX dry run's:

* train: the train-mode specs (:class:`repro_torch.distributed.sharding.
  TrainLayout`: TP over ``model``, ZeRO over the data axes, everything
  replicated below ``REPLICATE_BELOW``), AdamW moments beside them (bf16
  above 1e11 parameters), the batch rows over the data axes, the Trainer's
  step with :func:`repro_torch.launch.steps.pick_accum_steps` microbatches
  (an 8 GiB activation budget for DeepSeek-V3 on 512 ranks, else 4 GiB);
* prefill: the train-mode specs too, the forward under the training
  policy without gradients;
* decode: the serve-mode specs, each leaf stored as its JAX share
  (:class:`repro_torch.distributed.sharding.ServeLayout` with
  ``exact=True``), the caches as ``cache_pspecs`` place them (rows over the
  data axes, the sequence over ``model``, or over every axis for one
  row), the tokens' rows over the data axes; the step attends each rank's
  sequence shard and combines the shards' softmax sums
  (:func:`repro_torch.distributed.axes.decode_split`).

A ``1 x 1`` mesh (``--mesh 1x1``) places everything whole, with no process
group; on real tensors the same step runs (``chip_smoke.py``'s phase 19).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh single multi --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from typing import Dict, Optional

import torch

import repro_torch.configs as C
from repro_torch.analysis.aot import memory_record, trace_step
from repro_torch.configs.base import SHAPES
from repro_torch.configs.shapes import META, applicable, input_specs
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.launch.steps import make_decode_step, pick_accum_steps
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_init, cosine_schedule
from repro_torch.train import Trainer, TrainerConfig

MESHES = ("single", "multi", "1x1")
DEFAULT_OUT = "experiments/dryrun_torch"


def production_mesh(kind: str):
    """The mesh of a cell: rank 0's ``DeviceMesh`` of the single- or
    multi-pod production mesh over a ``fake`` default group of 256 or 512
    ranks (made here, replacing a fake group of another size), or None for
    ``"1x1"`` (one device, no group)."""
    if kind == "1x1":
        return None
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh

    multi = kind == "multi"
    world = math.prod(PRODUCTION_MESHES[multi][0])
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != world):
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group of ranks is initialised; the dry run "
                               "makes its own fake group")
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return make_production_mesh(multi_pod=multi)


def _local(tree, specs, mesh):
    """Meta tensors of the rank's shares of ``tree`` (meta tensors of the
    global shapes) under ``specs`` (a spec tree of the same keys)."""
    if isinstance(tree, dict):
        return {k: _local(v, specs[k], mesh) for k, v in tree.items()}
    if mesh is None:
        return tree
    idx = SH.shard_index(tuple(tree.shape), specs, mesh)
    return torch.empty([sl.stop - sl.start for sl in idx], dtype=tree.dtype, device=META)


def decode_pos(cfg, shape_name: str) -> int:
    """The absolute position of the dry run's decode token: the cache's last
    slot, inside an enc-dec decoder's learned position table."""
    s = SHAPES[shape_name].seq_len
    return min(s, cfg.max_decoder_positions) - 1 if cfg.n_encoder_layers else s - 1


def build_cell(cfg, shape_name: str, mesh, rows: Optional[int] = None):
    """Returns (fn, args, info): the step, rank 0's arguments on the meta
    device, and ``{"accum": microbatches}``.  ``mesh`` is a production
    ``DeviceMesh`` or None (one device); ``rows`` cuts the cell's global
    batch (a prefill or decode cell that must fit one device)."""
    info = {"accum": 1}
    spec = input_specs(cfg, shape_name, rows)
    if spec["kind"] == "decode":
        return _decode_cell(cfg, shape_name, spec, mesh) + (info,)
    layout = None if mesh is None else SH.TrainLayout(cfg, mesh)
    batch = spec["batch"]
    if mesh is not None:
        batch = _local(batch, SH.batch_pspecs(cfg, mesh, batch), mesh)
    shp = SHAPES[shape_name]
    dp_size = 1 if layout is None else layout.dp_size
    if spec["kind"] == "train":
        oc = OptConfig(moment_dtype=torch.bfloat16 if cfg.param_count() > 1e11
                       else torch.float32)
        n_dev = 1 if mesh is None else math.prod(mesh.shape)
        # the JAX dry run's hillclimbed cell: a bigger activation budget
        # halves DeepSeek-V3's microbatches (and FSDP gathers) on 512 ranks
        budget = (8 * 2**30 if (cfg.name == "deepseek-v3-671b" and n_dev == 512)
                  else 4 * 2**30)
        info["accum"] = pick_accum_steps(cfg, spec["batch"]["tokens"].shape[0], shp.seq_len,
                                         dp_size, budget_bytes=budget)
        tr = Trainer(cfg, mesh, TrainerConfig(accum_steps=info["accum"]), oc,
                     lr_fn=cosine_schedule(3e-4, 100, 10000), device=META)
        params = M.init_params(cfg, device=META, layout=tr.layout)
        if mesh is not None:
            tr.bind_shapes({k: tuple(v.shape) for k, v in spec["batch"].items()})
        return tr.step_fn, (params, adamw_init(params, oc), batch), info
    params = M.init_params(cfg, device=META, layout=layout)
    pol = None
    if layout is not None:
        rows = SH.batch_pspecs(cfg, mesh, {"tokens": spec["batch"]["tokens"]})["tokens"]
        pol = layout.policy(rows_split=rows[0] is not None and dp_size > 1)

    def prefill_step(params, batch):
        with torch.no_grad(), AX.policy(pol):
            return M.prefill(cfg, params, batch)

    return prefill_step, (params, batch), info


def _decode_cell(cfg, shape_name: str, spec: Dict, mesh):
    pos = decode_pos(cfg, shape_name)
    step = make_decode_step(cfg)
    if mesh is None:
        params = M.init_params(cfg, device=META)

        def decode_step(params, caches, tokens):
            with torch.no_grad():
                return step(params, caches, tokens, pos)

        return decode_step, (params, spec["caches"], spec["tokens"])
    layout = SH.ServeLayout(cfg, mesh, exact=True)
    params = M.init_params(cfg, device=META, layout=layout)
    caches = _local(spec["caches"], SH.cache_pspecs(cfg, mesh, spec["caches"]), mesh)
    tokens = _local({"tokens": spec["tokens"]},
                    SH.batch_pspecs(cfg, mesh, {"tokens": spec["tokens"]}), mesh)["tokens"]
    pol = layout.decode_policy(spec["caches"], tokens.shape[0], spec["tokens"].shape[0])

    def decode_step(params, caches, tokens):
        with torch.no_grad(), AX.policy(pol):
            return step(params, caches, tokens, pos)

    return decode_step, (params, caches, tokens)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Optional[str]) -> Dict:
    cfg = C.get_config(arch)
    ok, reason = applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        rec.update(status="skipped", reason=reason)
        _write(rec, out_dir)
        return rec
    try:
        mesh = production_mesh(mesh_kind)
        fn, args, info = build_cell(cfg, shape_name, mesh)
        art = trace_step(fn, args)
        rec.update(
            status="ok",
            trace_s=round(art.trace_s, 1),
            n_devices=1 if mesh is None else math.prod(mesh.shape),
            memory=memory_record(art),
            flops=float(art.flops),
            collectives=art.collectives,
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
            accum_steps=info.get("accum", 1),
        )
    except Exception as e:  # record the failure — failures here are bugs
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    _write(rec, out_dir)
    return rec


def _write(rec: Dict, out_dir: Optional[str]) -> None:
    """One record as ``<out_dir>/<arch>_<shape>_<mesh>.json`` (skips too:
    the roofline report lists them)."""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json".replace("/", "-")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"], choices=MESHES)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    archs = C.arch_ids() if args.arch == ["all"] else args.arch
    shapes = list(C.SHAPES) if args.shape == ["all"] else args.shape
    n_ok = n_err = n_skip = 0
    # mesh outermost: one fake group per mesh
    for mesh_kind in args.mesh:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, args.out)
                status = rec["status"]
                n_ok += status == "ok"
                n_err += status == "error"
                n_skip += status == "skipped"
                msg = rec.get("error", rec.get("reason", ""))
                extra = ""
                if status == "ok":
                    mem = rec["memory"]
                    extra = (f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB/dev "
                             f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
                             f"flops={rec['flops']:.3e} "
                             f"all-reduces={rec['collectives']['count']} "
                             f"trace={rec['trace_s']}s")
                print(f"[{status:7s}] {arch} x {shape} x {mesh_kind} {extra}{msg}",
                      flush=True)
    print(f"done: {n_ok} ok, {n_err} errors, {n_skip} skipped")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
