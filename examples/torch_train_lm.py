"""End-to-end training driver (PyTorch port): a ~100M-param LM.

Uses the full framework path: config -> trainer -> synthetic data pipeline
-> AdamW + cosine -> async checkpoints -> restart, on one device (the CUDA
card by default).  Training on a mesh of ranks: ``python -m
repro_torch.launch.train --mesh local`` under ``torchrun``.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      [--device cpu] [--tiny]
(``--tiny``: the smoke config, seconds on the CPU.)
"""
import argparse
import tempfile

import torch

import repro_torch.configs as C
from repro_torch.data import SyntheticLMData
from repro_torch.optim import OptConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = C.get_config("minicpm-2b", smoke=True, dtype=torch.float32)
        batch, seq = 8, 64
    else:
        # ~100M-param llama-style model (minicpm family, scaled down)
        cfg = C.get_config(
            "minicpm-2b", dtype=torch.float32,
            n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
            d_ff=2048, vocab_size=32000, q_chunk=128,
        )
        batch, seq = 16, 256
    print(f"model: {cfg.name}  ~{cfg.param_count() / 1e6:.0f}M params")

    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt_dir:
        tc = TrainerConfig(steps=args.steps, checkpoint_every=100, checkpoint_dir=ckpt_dir,
                           log_every=10, step_deadline_s=300.0)
        tr = Trainer(cfg, None, tc, OptConfig(lr=3e-4),
                     device=None if args.device == "cuda" else args.device)
        _params, _opt, hist = tr.fit(SyntheticLMData(cfg, global_batch=batch, seq_len=seq))
        print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              f"(last checkpoint: step {tr.ckpt.latest_step()})")


if __name__ == "__main__":
    main()
