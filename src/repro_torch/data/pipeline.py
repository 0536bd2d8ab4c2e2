"""Data pipeline: a deterministic synthetic LM stream and memory-mapped
token files.

Counterpart of ``repro.data.pipeline``.  The synthetic stream is numpy
seeded by (seed, step, row), so a batch depends only on (seed, step): runs
are reproducible, a restart resumes the same stream, and the batches are
bit-equal to the JAX package's, frontend stubs included.  Batches are host
tensors; the trainer moves them to its device.  The JAX package's per-shard batches (``make_batch_sharded``,
``batch(shardings=...)``) need the training mesh, which is not ported yet
(ROADMAP.md queue 1 item 26, its training half): they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

MESH_NOT_PORTED = ("mesh-sharded batches are not ported yet (ROADMAP.md queue 1 "
                   "item 26, its training half)")


def make_batch_sharded(global_shape, dtype, sharding, fill_fn):
    """The JAX package builds a global array shard by shard on a mesh."""
    raise NotImplementedError(MESH_NOT_PORTED)


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

    def batch(self, step: int, shardings: Optional[Dict] = None) -> Dict:
        """One {tokens, labels} batch (+ frontend stubs): ``labels`` are the
        tokens shifted left by one (the row's first token wraps to the
        end), as in the JAX package."""
        if shardings is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        B, S = self.global_batch, self.seq_len
        t = self._tokens(step, 0, B)
        batch = {"tokens": torch.from_numpy(t),
                 "labels": torch.from_numpy(np.roll(t, -1, 1))}
        cfg = self.cfg
        if cfg.frontend == "vision":
            nv = min(cfg.n_frontend_tokens, S)
            rng = np.random.default_rng(self.seed + 7 + step)
            img = rng.standard_normal((B, nv, cfg.d_model)).astype(np.float32)
            batch["vis_embeds"] = torch.from_numpy(img).to(cfg.dtype)
            batch["positions3"] = torch.arange(S, dtype=torch.int32)[None, None].expand(3, B, S)
        if cfg.frontend == "audio":
            rng = np.random.default_rng(self.seed + 11 + step)
            audio = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            batch["audio_embeds"] = torch.from_numpy(audio).to(cfg.dtype)
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

    def batch(self, step: int) -> Dict:
        rng = np.random.default_rng(self.seed + step)
        starts = rng.integers(0, self._n, size=self.global_batch)
        toks = np.stack([self._mm[s:s + self.seq_len] for s in starts])
        labs = np.stack([self._mm[s + 1:s + self.seq_len + 1] for s in starts])
        return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
