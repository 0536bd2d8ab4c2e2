"""Training entry point, on the CUDA card by default.

Counterpart of ``python -m repro.launch.train``; ``--device cpu`` runs on
the CPU (with ``--smoke``, the reduced config in fp32):

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --smoke \\
      --device cpu --steps 30 --batch 8 --seq 64 --ckpt /tmp/ckpt

Without ``--smoke`` the full config trains in bf16 with fp32 moments, as
the JAX CLI does, e.g. minicpm-2b at full width and depth on one card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 30 --batch 4 --seq 512 --wsd

``--mesh local`` trains on ``make_local_mesh()``, a ``1 x world`` mesh
over the ranks that ``torchrun`` (``python -m torch.distributed.run``)
starts; started alone, the CLI spawns one rank per visible card (one rank
on the CPU).  The ranks join with gloo on the CPU or where they share a
card, NCCL where each has its own; rank 0 alone prints:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train --arch minicpm-2b --smoke --device cpu \
      --steps 30 --batch 8 --seq 64 --mesh local

``--mesh single`` and ``--mesh multi`` train on the JAX CLI's production
meshes (``make_production_mesh``: 16 x 16 over 256 ranks, 2 x 16 x 16 over
512) under a ``torchrun`` of that many ranks; started alone, the CLI says
so and exits.  ``python -m repro_torch.launch.dryrun`` traces those cells
on the meta device without the ranks.
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile

import torch

import repro_torch.configs as C
from repro_torch.core.encoder import resolve_device
from repro_torch.data import SyntheticLMData
from repro_torch.optim import OptConfig, wsd_schedule
from repro_torch.train import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=C.arch_ids())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the parameters, the optimizer state and the steps run")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["local", "single", "multi"], default=None,
                    help="local: train on a 1 x world mesh (spawns the ranks unless "
                         "started under torchrun); single/multi: the production meshes "
                         "(256 / 512 ranks under torchrun)")
    ap.add_argument("--wsd", action="store_true",
                    help="WSD schedule (MiniCPM) instead of cosine")
    ap.add_argument("--grad-compression", choices=["int8"], default=None)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-step straggler deadline (s)")
    return ap


def train(args, device: torch.device, mesh=None) -> None:
    """Build the config, the trainer and the data, fit, and print the
    losses (rank 0 alone on a mesh)."""
    cfg = C.get_config(args.arch, smoke=args.smoke,
                       dtype=torch.float32 if args.smoke else torch.bfloat16)
    lr_fn = None
    if args.wsd:
        lr_fn = wsd_schedule(args.lr, args.steps // 10, args.steps * 7 // 10, args.steps // 5)
    tc = TrainerConfig(
        steps=args.steps, accum_steps=args.accum, checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt, step_deadline_s=args.deadline,
        grad_compression=args.grad_compression,
    )
    tr = Trainer(cfg, mesh, tc, OptConfig(lr=args.lr), lr_fn=lr_fn, device=device)
    data = SyntheticLMData(cfg, global_batch=args.batch, seq_len=args.seq)
    _, _, hist = tr.fit(data)
    if not tr.rank0:
        return
    where = (f"{device}" if mesh is None
             else f"{device}, mesh {'x'.join(map(str, mesh.shape))}")
    out = [f"final loss: {hist[-1]['loss']:.6f} (start {hist[0]['loss']:.6f}) on {where}"]
    if tr.straggler_events:
        out.append(f"straggler events: {len(tr.straggler_events)}")
    sys.stdout.write("".join(f"{line}\n" for line in out))


def _run_rank(rank: int, args, world: int, store: str) -> None:
    """One rank of ``--mesh local``: join the group (a file store, or
    torchrun's environment when ``store`` is empty), train, leave."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.launch.serve import DIST_TIMEOUT_S, _backend, _rank_device

    device = _rank_device(args, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    kw = ({"store": dist.FileStore(store, world), "rank": rank, "world_size": world}
          if store else {})
    dist.init_process_group(_backend(device.type, world),
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S), **kw)
    try:
        mesh = (make_local_mesh() if args.mesh == "local"
                else make_production_mesh(multi_pod=args.mesh == "multi"))
        train(args, device, mesh)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = build_parser().parse_args(argv)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.mesh in ("single", "multi") and not torchrun:
        n = 512 if args.mesh == "multi" else 256
        raise SystemExit(f"--mesh {args.mesh} trains on the production mesh of {n} ranks: "
                         f"start them under torchrun (--nproc-per-node ... --nnodes ...), "
                         f"or trace its cells on the meta device with "
                         f"python -m repro_torch.launch.dryrun --mesh {args.mesh}")
    # "cuda" resolves like an entry point's default: it raises without CUDA
    device = resolve_device(None if args.device == "cuda" else args.device)
    if args.mesh is None:
        train(args, device)
        return
    if torchrun:
        _run_rank(int(os.environ["RANK"]), args, int(os.environ["WORLD_SIZE"]), "")
        return
    import torch.multiprocessing as mp

    world = torch.cuda.device_count() if device.type == "cuda" else 1
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_run_rank, args=(args, world, os.path.join(tmp, "store")),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
