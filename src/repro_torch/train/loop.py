"""Training loop with the JAX package's fault-tolerance machinery, on one
device or on a ``D x M`` mesh.

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
package's ``PRNGKey``).  The trainer runs on the CUDA device unless
``device`` says otherwise, and raises without CUDA.

**On a mesh** (``mesh=``, a ``DeviceMesh`` named ``("data", "model")``,
or ``("pod", "data", "model")`` with the data axes taken as one, from
:mod:`repro_torch.launch.mesh`, every rank running the same calls):
each rank stores its slices of the parameters and of both moments under
the train-mode specs (:class:`repro_torch.distributed.sharding.
TrainLayout`: TP over ``model``, ZeRO over ``data``, all replicated below
``REPLICATE_BELOW``), drawn by shards from the single device's generator
sequence (the same numbers, cut); it takes its rows of each batch, runs
its share of the loss under the training policy (each layer's leaves
gathered just before the layer), reduces the gradients over ``data``,
clips by the global norm over the shards and updates its shards.  The
logged loss is the global one, the same on every rank; rank 0 prints.
Checkpoints hold the logical, unsharded leaves and restore onto any mesh
(the elastic restart).  Accumulation splits the rank's rows; the straggler
watchdog runs per rank.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.encoder import resolve_device
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.train.compression import dequantize_leaf, quantize_leaf


def check_train_mesh(mesh) -> None:
    """Refuse what is not a mesh of ranks: ``TypeError`` for an object that
    is not a ``DeviceMesh`` (an abstract mesh has no ranks to train on)."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, AX.AbstractMesh):
        raise TypeError("an abstract mesh has no ranks to train on; build the mesh with "
                        "repro_torch.launch.mesh over a process group")
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh named "
                        f"('data', 'model') (repro_torch.launch.mesh) or None, "
                        f"not {type(mesh).__name__}")
    if tuple(mesh.mesh_dim_names or ()) not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"the training mesh's axes must be ('data', 'model') or "
                         f"('pod', 'data', 'model'), not {mesh.mesh_dim_names}")


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
            check_train_mesh(mesh)
        tc = tc or TrainerConfig()
        oc = oc or OptConfig()
        self.cfg, self.tc, self.oc, self.mesh = cfg, tc, oc, mesh
        self.device = resolve_device(device)
        # collective on a mesh: every rank builds its trainer at this point
        self.layout = SH.TrainLayout(cfg, mesh) if mesh is not None else None
        self.rank0 = mesh is None or dist.get_rank() == 0
        self._policy = None
        self.lr_fn = lr_fn or cosine_schedule(oc.lr, 10, tc.steps)
        self.ckpt = (CheckpointManager(tc.checkpoint_dir, tc.keep_last_k)
                     if tc.checkpoint_dir else None)
        self.straggler_events: List[Dict] = []

    # ------------------------------------------------------------------

    def step_fn(self, params, opt_state, batch):
        """One step: the loss over the microbatches and its gradients, the
        optional int8 round trip, AdamW in place (the JAX package donates
        the state to its jitted step).  Returns (params, opt_state,
        metrics).  On a mesh: the rank's shards and rows, under the
        training policy (:meth:`bind` first); the metrics are global."""
        tc, lay = self.tc, self.layout
        if lay is not None and self._policy is None:
            raise RuntimeError("bind the trainer to its data first (Trainer.bind)")
        with AX.policy(self._policy):
            loss, metrics, grads = loss_and_grads(self.cfg, params, batch,
                                                  accum_steps=tc.accum_steps)
        if tc.accum_steps > 1:  # the JAX trainer's metrics for a scanned loss
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        reduce_sumsq = None
        if lay is not None:
            grads = lay.reduce_grads(params, grads)
            loss, metrics = self._global_metrics(loss, metrics)
            reduce_sumsq = functools.partial(lay.global_sumsq, params)
        if tc.grad_compression == "int8":
            # the stateless round trip: the wire format's error, each leaf
            # at its whole leaf's scale
            scales = [None] * len(grads)
            if lay is not None:
                top = lay.global_max(torch.stack([g.float().abs().max() for g in grads]))
                scales = list(top / 127.0 + 1e-12)
            grads = [dequantize_leaf(*quantize_leaf(g, s), g.dtype)
                     for g, s in zip(grads, scales)]
        lr_now = self.lr_fn(opt_state["step"])
        params, opt_state = adamw_update(T.unflatten(params, grads), opt_state, params,
                                         self.oc, lr_now, donate=True,
                                         reduce_sumsq=reduce_sumsq)
        return params, opt_state, {"loss": loss, "lr": lr_now, **metrics}

    def _global_metrics(self, loss, metrics):
        """The ranks' shares of the loss and metrics summed over ``data``."""
        names = list(metrics)
        v = torch.stack([loss] + [metrics[k].float() for k in names]).contiguous()
        if self.layout.dp_size > 1:
            dist.all_reduce(v, group=self.layout.groups["data"])
        return v[0], dict(zip(names, v[1:]))

    def bind(self, data):
        """On a mesh: the shardings of ``data``'s batches (its rows over
        ``data`` by ``batch_pspecs``, small batches replicated) and the
        training policy that goes with them; None on one device."""
        return None if self.layout is None else self.bind_shapes(data.shapes())

    def bind_shapes(self, shapes):
        """:meth:`bind` for batches of ``shapes`` (``{name: global shape}``)."""
        specs = SH.batch_pspecs(self.cfg, self.mesh, shapes)
        shardings = {k: SH.Sharding(self.mesh, v) for k, v in specs.items()}
        rows = specs["tokens"][0] is not None and self.layout.dp_size > 1
        self._policy = self.layout.policy(rows_split=rows)
        return shardings

    # ------------------------------------------------------------------

    def init_state(self):
        """The initial parameters and moments: on a mesh the rank's slices,
        drawn by shards (the single device's numbers, cut)."""
        generator = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = M.init_params(self.cfg, generator, device=self.device, layout=self.layout)
        return params, adamw_init(params, self.oc)

    def shardings(self, state):
        """The ``Sharding`` records of a ``(params, opt_state)`` pair on the
        mesh (None on one device)."""
        return None if self.layout is None else self.layout.shardings(state)

    def restore_or_init(self):
        params, opt = self.init_state()
        if self.ckpt and self.ckpt.latest_step() is not None:
            step, (params, opt) = self.ckpt.restore((params, opt), device=self.device,
                                                    shardings=self.shardings((params, opt)))
            return step, params, opt
        return 0, params, opt

    # ------------------------------------------------------------------

    def fit(self, data, *, start_step: Optional[int] = None):
        step0, params, opt = self.restore_or_init()
        if start_step is not None:
            step0 = start_step
        shardings = self.bind(data)
        kw = {} if shardings is None else {"shardings": shardings}
        history = []
        for step in range(step0, self.tc.steps):
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in data.batch(step, **kw).items()}
            t0 = time.perf_counter()
            params, opt, metrics = self.step_fn(params, opt, batch)
            loss = float(metrics["loss"])  # the sync point (and the step barrier)
            dt = time.perf_counter() - t0
            if self.tc.step_deadline_s and dt > self.tc.step_deadline_s:
                self.straggler_events.append({"step": step, "seconds": dt, "action": "logged"})
            if step % self.tc.log_every == 0:
                history.append({"step": step, "loss": loss, "s": dt})
                if self.rank0:
                    print(f"step {step:6d} loss {loss:.4f} ({dt:.2f}s)", flush=True)  # repro: noqa RPR005 -- training progress log
            if (self.ckpt and self.tc.checkpoint_every and step > 0
                    and step % self.tc.checkpoint_every == 0):
                self.ckpt.save(step, (params, opt), shardings=self.shardings((params, opt)))
        if self.ckpt:
            self.ckpt.save(self.tc.steps, (params, opt), blocking=True,
                           shardings=self.shardings((params, opt)))
        return params, opt, history
