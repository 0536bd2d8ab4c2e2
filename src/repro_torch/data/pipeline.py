"""Data pipeline: a deterministic synthetic LM stream and memory-mapped
token files.

Counterpart of ``repro.data.pipeline``.  The synthetic stream is numpy
seeded by (seed, step, row), so a batch depends only on (seed, step): runs
are reproducible, a restart resumes the same stream, and the batches are
bit-equal to the JAX package's, frontend stubs included.  Batches are host
tensors; the trainer moves them to its device.

On a mesh a rank builds only its part of a batch: ``batch(step,
shardings=)`` takes a :class:`repro_torch.distributed.sharding.Sharding`
per key (specs from ``batch_pspecs``) and fills the rank's rows alone
(:func:`make_batch_sharded`), bit-equal to the same rows of the global
batch.  The global shapes are those of the unsharded batch (tokens and
labels carry ``seq_len + 1`` columns); the JAX package's sharded path
declares ``seq_len`` columns for the same fill, which it then refuses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def make_batch_sharded(global_shape, dtype, sharding, fill_fn) -> torch.Tensor:
    """This rank's part of a global array of ``global_shape``, placed by
    ``sharding`` (a :class:`~repro_torch.distributed.sharding.Sharding`):
    ``fill_fn(index)`` gets the rank's index tuple (one ``slice`` per dim,
    as ``jax.make_array_from_callback`` hands it) and returns its part,
    made a host tensor of ``dtype`` (a numpy dtype)."""
    from repro_torch.distributed.sharding import shard_index

    index = shard_index(tuple(global_shape), sharding.spec, sharding.mesh)
    part = np.ascontiguousarray(np.asarray(fill_fn(index), dtype=dtype))
    want = tuple(sl.stop - sl.start for sl in index)
    if part.shape != want:
        raise ValueError(f"fill_fn gave a part of shape {part.shape}; the index "
                         f"{index} of {tuple(global_shape)} needs {want}")
    return torch.from_numpy(part)


def _cut(full: torch.Tensor, sharding) -> torch.Tensor:
    """The rank's part of a whole host tensor (None: all of it)."""
    if sharding is None:
        return full
    from repro_torch.distributed.sharding import local_shard

    return local_shard(full, sharding.spec, sharding.mesh).contiguous()


@dataclasses.dataclass
class SyntheticLMData:
    """Deterministic synthetic next-token stream (zipf-ish token marginals)."""

    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0

    def _tokens(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the global batch at ``step`` -- a pure function."""
        rows = []
        for r in range(lo, hi):
            rng = np.random.default_rng((self.seed * 1_000_003 + step) * 131_071 + r)
            # zipf-like marginals bounded to the vocabulary
            z = rng.zipf(1.3, size=self.seq_len + 1)
            rows.append(np.minimum(z - 1, self.cfg.vocab_size - 1))
        return np.stack(rows).astype(np.int32)

    def shapes(self) -> Dict:
        """The global shape of every leaf of a batch."""
        B, S, cfg = self.global_batch, self.seq_len, self.cfg
        out = {"tokens": (B, S + 1), "labels": (B, S + 1)}
        if cfg.frontend == "vision":
            out["vis_embeds"] = (B, min(cfg.n_frontend_tokens, S), cfg.d_model)
            out["positions3"] = (3, B, S)
        if cfg.frontend == "audio":
            out["audio_embeds"] = (B, cfg.encoder_seq, cfg.d_model)
        return out

    def batch(self, step: int, shardings: Optional[Dict] = None) -> Dict:
        """One {tokens, labels} batch (+ frontend stubs): ``labels`` are the
        tokens shifted left by one (the row's first token wraps to the
        end), as in the JAX package.  With ``shardings`` (a
        :class:`~repro_torch.distributed.sharding.Sharding` per key) the
        rank's part only, its token rows drawn alone."""
        B, S = self.global_batch, self.seq_len
        shardings = shardings or {}
        if "tokens" in shardings:
            def rows(index):
                return self._tokens(step, index[0].start, index[0].stop)[:, index[1]]

            def shifted(index):  # the roll is along the columns, all of them
                return np.roll(self._tokens(step, index[0].start, index[0].stop), -1,
                               1)[:, index[1]]

            batch = {"tokens": make_batch_sharded((B, S + 1), np.int32, shardings["tokens"],
                                                  rows),
                     "labels": make_batch_sharded((B, S + 1), np.int32,
                                                  shardings.get("labels", shardings["tokens"]),
                                                  shifted)}
        else:
            t = self._tokens(step, 0, B)
            batch = {"tokens": torch.from_numpy(t),
                     "labels": torch.from_numpy(np.roll(t, -1, 1))}
        cfg = self.cfg
        if cfg.frontend == "vision":
            nv = min(cfg.n_frontend_tokens, S)
            rng = np.random.default_rng(self.seed + 7 + step)
            img = rng.standard_normal((B, nv, cfg.d_model)).astype(np.float32)
            batch["vis_embeds"] = _cut(torch.from_numpy(img).to(cfg.dtype),
                                       shardings.get("vis_embeds"))
            batch["positions3"] = _cut(
                torch.arange(S, dtype=torch.int32)[None, None].expand(3, B, S),
                shardings.get("positions3"))
        if cfg.frontend == "audio":
            rng = np.random.default_rng(self.seed + 11 + step)
            audio = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            batch["audio_embeds"] = _cut(torch.from_numpy(audio).to(cfg.dtype),
                                         shardings.get("audio_embeds"))
        return batch

    def __iter__(self) -> Iterator[Dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class TokenFileData:
    """Memory-mapped pre-tokenized corpus (one flat int32 token stream)."""

    path: str
    global_batch: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        self._mm = np.memmap(self.path, dtype=np.int32, mode="r")
        self._n = len(self._mm) - self.seq_len - 1
        if self._n <= 0:
            raise ValueError(f"{self.path} too small for seq_len {self.seq_len}")

    def shapes(self) -> Dict:
        """The global shape of every leaf of a batch."""
        return {"tokens": (self.global_batch, self.seq_len),
                "labels": (self.global_batch, self.seq_len)}

    def batch(self, step: int, shardings: Optional[Dict] = None) -> Dict:
        """One {tokens, labels} batch; with ``shardings`` the rank's part."""
        rng = np.random.default_rng(self.seed + step)
        starts = rng.integers(0, self._n, size=self.global_batch)
        toks = np.stack([self._mm[s:s + self.seq_len] for s in starts])
        labs = np.stack([self._mm[s + 1:s + self.seq_len + 1] for s in starts])
        shardings = shardings or {}
        return {"tokens": _cut(torch.from_numpy(toks), shardings.get("tokens")),
                "labels": _cut(torch.from_numpy(labs), shardings.get("labels"))}
