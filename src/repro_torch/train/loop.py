"""Training loop with the JAX package's fault-tolerance machinery, on one
device.

Counterpart of ``repro.train.loop``:

* **microbatching** -- gradient accumulation over ``accum_steps``, one
  backward pass per microbatch (the global batch stays the same while the
  live activations shrink);
* **checkpoint/restart** -- async atomic snapshots
  (:mod:`repro_torch.checkpoint`); on start the trainer resumes from the
  latest step;
* **straggler watchdog** -- a per-step deadline; steps past it are recorded;
* **data determinism** -- the batch at step N depends only on (seed, N);
* **grad compression** -- ``grad_compression="int8"`` runs the int8 round
  trip of :mod:`repro_torch.train.compression` on the gradients.

Parameters are drawn from ``TrainerConfig.seed`` with an explicit
``torch.Generator`` on the trainer's device (other numbers than the JAX
package's ``PRNGKey``).  A mesh (elastic resharding, the DP reduction) is
not ported yet: ``mesh=`` raises (ROADMAP.md queue 1 item 26, its training
half; serving takes a mesh).  The trainer
runs on the CUDA device unless ``device`` says otherwise, and raises
without CUDA.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.encoder import resolve_device
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.train.compression import dequantize_leaf, quantize_leaf

MESH_NOT_PORTED = ("mesh-sharded training is not ported yet (ROADMAP.md queue 1 item 26, "
                   "its training half)")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    accum_steps: int = 1
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_last_k: int = 3
    step_deadline_s: Optional[float] = None  # straggler watchdog
    log_every: int = 10
    grad_compression: Optional[str] = None  # None | "int8"
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, mesh=None, tc: Optional[TrainerConfig] = None,
                 oc: Optional[OptConfig] = None, lr_fn: Optional[Callable] = None, *,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        tc = tc or TrainerConfig()
        oc = oc or OptConfig()
        self.cfg, self.tc, self.oc = cfg, tc, oc
        self.device = resolve_device(device)
        self.lr_fn = lr_fn or cosine_schedule(oc.lr, 10, tc.steps)
        self.ckpt = (CheckpointManager(tc.checkpoint_dir, tc.keep_last_k)
                     if tc.checkpoint_dir else None)
        self.straggler_events: List[Dict] = []

    # ------------------------------------------------------------------

    def step_fn(self, params, opt_state, batch):
        """One step: the loss over the microbatches and its gradients, the
        optional int8 round trip, AdamW in place (the JAX package donates
        the state to its jitted step).  Returns (params, opt_state,
        metrics)."""
        tc = self.tc
        loss, metrics, grads = loss_and_grads(self.cfg, params, batch,
                                              accum_steps=tc.accum_steps)
        if tc.accum_steps > 1:  # the JAX trainer's metrics for a scanned loss
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        if tc.grad_compression == "int8":
            # the stateless round trip: the wire format's error
            grads = [dequantize_leaf(*quantize_leaf(g), g.dtype) for g in grads]
        lr_now = self.lr_fn(opt_state["step"])
        params, opt_state = adamw_update(T.unflatten(params, grads), opt_state, params,
                                         self.oc, lr_now, donate=True)
        return params, opt_state, {"loss": loss, "lr": lr_now, **metrics}

    # ------------------------------------------------------------------

    def init_state(self):
        generator = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = M.init_params(self.cfg, generator, device=self.device)
        return params, adamw_init(params, self.oc)

    def restore_or_init(self):
        params, opt = self.init_state()
        if self.ckpt and self.ckpt.latest_step() is not None:
            step, (params, opt) = self.ckpt.restore((params, opt), device=self.device)
            return step, params, opt
        return 0, params, opt

    # ------------------------------------------------------------------

    def fit(self, data, *, start_step: Optional[int] = None):
        step0, params, opt = self.restore_or_init()
        if start_step is not None:
            step0 = start_step
        history = []
        for step in range(step0, self.tc.steps):
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in data.batch(step).items()}
            t0 = time.perf_counter()
            params, opt, metrics = self.step_fn(params, opt, batch)
            loss = float(metrics["loss"])  # the sync point (and the step barrier)
            dt = time.perf_counter() - t0
            if self.tc.step_deadline_s and dt > self.tc.step_deadline_s:
                self.straggler_events.append({"step": step, "seconds": dt, "action": "logged"})
            if step % self.tc.log_every == 0:
                history.append({"step": step, "loss": loss, "s": dt})
                print(f"step {step:6d} loss {loss:.4f} ({dt:.2f}s)", flush=True)  # repro: noqa RPR005 -- training progress log
            if (self.ckpt and self.tc.checkpoint_every and step > 0
                    and step % self.tc.checkpoint_every == 0):
                self.ckpt.save(step, (params, opt))
        if self.ckpt:
            self.ckpt.save(self.tc.steps, (params, opt), blocking=True)
        return params, opt, history
