"""Training entry point, on the CUDA card by default.

Counterpart of ``python -m repro.launch.train``; ``--device cpu`` runs on
the CPU (with ``--smoke``, the reduced config in fp32):

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --smoke \\
      --device cpu --steps 30 --batch 8 --seq 64 --ckpt /tmp/ckpt

Without ``--smoke`` the full config trains in bf16 with fp32 moments, as
the JAX CLI does, e.g. minicpm-2b at full width and depth on one card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 30 --batch 4 --seq 512 --wsd

The JAX CLI's ``--mesh`` is not ported for training: any value raises
(ROADMAP.md queue 1 item 26, its training half; the serving CLI takes it).
"""
from __future__ import annotations

import argparse
import sys

import torch

import repro_torch.configs as C
from repro_torch.core.encoder import resolve_device
from repro_torch.data import SyntheticLMData
from repro_torch.optim import OptConfig, wsd_schedule
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.loop import MESH_NOT_PORTED


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
                    help="not ported: raises")
    ap.add_argument("--wsd", action="store_true",
                    help="WSD schedule (MiniCPM) instead of cosine")
    ap.add_argument("--grad-compression", choices=["int8"], default=None)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-step straggler deadline (s)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh is not None:
        raise SystemExit(MESH_NOT_PORTED)
    # "cuda" resolves like an entry point's default: it raises without CUDA
    device = resolve_device(None if args.device == "cuda" else args.device)
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
    tr = Trainer(cfg, None, tc, OptConfig(lr=args.lr), lr_fn=lr_fn, device=device)
    data = SyntheticLMData(cfg, global_batch=args.batch, seq_len=args.seq)
    _, _, hist = tr.fit(data)
    out = [f"final loss: {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f}) on {device}"]
    if tr.straggler_events:
        out.append(f"straggler events: {len(tr.straggler_events)}")
    sys.stdout.write("".join(f"{line}\n" for line in out))


if __name__ == "__main__":
    main()
