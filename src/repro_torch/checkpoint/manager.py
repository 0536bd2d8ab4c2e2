"""Checkpointing: asynchronous, atomic, in the JAX package's layout.

Counterpart of ``repro.checkpoint.manager``.  One directory per step::

    <dir>/step_00000123/
        META.json          # step, leaf count, shapes, dtypes, paths
        leaf_00000.npy ... # one file per leaf, row-major, whole

* **atomic**: written to ``step_X.tmp``, then renamed -- a crash mid-save
  never corrupts the latest checkpoint;
* **async**: the train loop hands over a host copy and keeps stepping; a
  writer thread owns the IO, one save outstanding at a time, and an error
  of the writer is raised by the next :meth:`CheckpointManager.wait`;
* **keep_last_k** bounds the disk;
* **the JAX package's leaf order** (:mod:`repro_torch.tree`: dict keys
  sorted), so an fp32 checkpoint written by either package restores in the
  other.  numpy has no bfloat16: a bf16 leaf is stored as its 16-bit
  patterns (``uint16``) with ``bfloat16`` named in ``META.json``;
* **independent of the mesh**: on a mesh (``shardings=``, a
  :class:`~repro_torch.distributed.sharding.Sharding` per leaf) ``save``
  gathers each leaf once into its logical, unsharded whole, rank 0 writes
  it, and the ranks meet at a barrier (after a blocking write; after an
  asynchronous one at the next :meth:`CheckpointManager.wait`, which every
  rank then calls at the same point); ``restore(..., shardings=)`` reads
  each leaf and keeps the rank's slice, whatever mesh wrote it -- the
  elastic restart.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.encoder import resolve_device

_DTYPE_NAME = {torch.bfloat16: "bfloat16"}


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``x`` -- a copy on the CPU too, since the trainer
    updates its state in place while the writer runs; a bf16 tensor as its
    uint16 bit patterns."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
    return x.to("cpu", copy=True).numpy()


def _from_host(a: np.ndarray, dtype_name: str, like: torch.Tensor, device) -> torch.Tensor:
    """The stored leaf as a tensor of ``like``'s dtype on ``device``."""
    a = np.asarray(a, order="C")  # a 0-d leaf (the step) stays 0-d
    if dtype_name == "bfloat16":  # 16-bit patterns (either package's)
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep_last_k: int = 3):
        self.directory = directory
        self.keep_last_k = keep_last_k
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier_due = False  # an asynchronous save on a mesh

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, *, blocking: bool = False,
             shardings: Any = None) -> None:
        """Snapshot ``tree`` at ``step``; the write runs in the background
        unless ``blocking``.  With ``shardings`` (a tree of ``Sharding``
        matching ``tree``), ``tree`` holds this rank's shards: every rank
        calls ``save``, each leaf is gathered whole, and rank 0 writes."""
        self.wait()  # one outstanding save at a time
        leaves = T.leaves(tree)
        if shardings is not None:
            import torch.distributed as dist

            from repro_torch.distributed.sharding import gather_full

            writer = dist.get_rank() == 0
            host_leaves = []
            for x, sh in zip(leaves, T.leaves(shardings)):
                full = gather_full(x.detach(), sh.spec, sh.mesh)
                host_leaves.append(_to_host(full) if writer else None)
                del full
            self._barrier_due = True  # every rank meets the others at wait()
            if not writer:
                if blocking:
                    self.wait()
                return
        else:
            host_leaves = [_to_host(x) for x in leaves]  # the host copy, now
        meta = {
            "step": int(step),
            "n_leaves": len(leaves),
            "shapes": [list(x.shape) for x in host_leaves],
            "dtypes": [_DTYPE_NAME.get(x.dtype, str(np.dtype(h.dtype)))
                       for x, h in zip(leaves, host_leaves)],
            "paths": T.paths(tree),
            "time": time.time(),
        }

        def write():
            try:
                final = os.path.join(self.directory, f"step_{step:08d}")
                tmp = final + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                for i, arr in enumerate(host_leaves):
                    np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
                with open(os.path.join(tmp, "META.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Wait for the outstanding save; after one on a mesh, every rank
        meets the others here (collective)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier_due:
            import torch.distributed as dist

            self._barrier_due = False
            dist.barrier()
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}") from err

    def _gc(self) -> None:
        steps = self.available_steps()
        for s in steps[: -self.keep_last_k]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def available_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, *, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Tuple[int, Any]:
        """Load step ``step`` (the latest when None) into the structure and
        dtypes of ``like``, every leaf on ``device`` (default ``"cuda"``;
        raises without CUDA): a trainer passes its own device, where its
        target tree lives.  With ``shardings`` (a tree of ``Sharding``
        matching ``like``) each rank keeps its slice of every stored leaf."""
        device = resolve_device(device)
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "META.json")) as f:
            meta = json.load(f)
        targets = T.leaves(like)
        if len(targets) != meta["n_leaves"]:
            raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, target {len(targets)}")
        cuts = [None] * len(targets) if shardings is None else T.leaves(shardings)
        loaded = []
        for i, (name, x, sh) in enumerate(zip(meta["dtypes"], targets, cuts)):
            a = np.load(os.path.join(d, f"leaf_{i:05d}.npy"), mmap_mode="r")
            if sh is not None:
                from repro_torch.distributed.sharding import shard_index

                a = a[shard_index(a.shape, sh.spec, sh.mesh)]
            loaded.append(_from_host(np.array(a), name, x, device))  # off the mapping
        return step, T.unflatten(like, loaded)
