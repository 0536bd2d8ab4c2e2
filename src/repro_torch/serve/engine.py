"""Serving engines: static-wave batching and continuous batching.

Counterpart of ``repro.serve.engine``.  Two engines share the model's
prefill/decode functions:

* :class:`Server` -- the **static-wave** engine: one batch of requests
  prefills together, decodes in lockstep, and the wave drains before the
  next starts.  Single-request ``generate`` is the parity baseline of the
  continuous engine.
* :class:`Engine` -- **continuous batching** over the block-paged KV cache
  (:mod:`repro_torch.serve.kvcache`): a scheduler admits requests from a
  queue into batch slots as pages free up, each slot advances at its own
  position, and a finished slot is re-filled the same step.  The decode step
  runs all ``max_seqs`` slots together; its paged attention and
  copy-on-write go through ``EngineConfig.backend`` -- the CUDA kernels
  (``"cuda"``, the default) or the gather oracle (``"reference"``).

**Chunked prefill**: admission feeds a prompt through the model in
page-sized chunks (:func:`repro_torch.models.model.prefill_chunk`), each
chunk's K/V scattered straight into its physical pages, in place -- no
admission copies the pool, and a long prompt interleaves with the running
batch's decode steps instead of stalling it.  Final chunks are bucketed to
powers of two, as in the JAX package.

**Shared-prefix paged KV**: physical pages are reference-counted, and a
radix prefix index over page-aligned token prefixes lets an admission
*alias* the pages of a prompt's longest cached prefix; a decode write into a
still-shared page copies-on-write.

**Deferred host sync**: the greedy decode loop feeds each step's sampled
tokens back on the device and copies them to the host only at scheduling
events (finish, preemption, EOS) -- the methods marked ``# repro:
hot-loop`` call neither ``.item()`` nor ``.cpu()`` except at the two
sanctioned sync points.  Host inputs (positions, page tables, write
targets) go up through pinned memory without a sync.

Where the JAX package jits and memoizes its step functions (and inventories
them for its compiled-artifact linter), this engine calls the model's
functions eagerly (:func:`step_fns`, which
:mod:`repro_torch.analysis.torchcheck` inventories).  Entry points run on the CUDA device unless ``device``
says otherwise.

**Serving on a mesh** (``mesh=``, a ``D x M`` mesh from
:func:`repro_torch.launch.mesh.make_serve_mesh`): every rank builds the
engine at the same point and runs the same host schedule on the same full
batch.  It takes either the full parameters (the JAX API; the rank keeps
its shards once, at construction) or a tree its
:class:`~repro_torch.distributed.sharding.ServeLayout` drew by shards
(``init_params(layout=)``: no rank ever holds the full tree), and stores
the JAX serve mode's share of each leaf, resident.  The model runs on the
rank's model slice of heads and its share of the widths and experts,
summing row-parallel products over the ranks that split them with
``all_reduce`` (the rank's pools hold the model slice's kv heads,
replicated over the data axis; the paged kernels simply receive them);
every rank reads the same reduced logits, so the sampled tokens -- greedy,
or drawn from the same seeded generator -- are the same on every rank
without a collective of their own.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_backend
from repro_torch.core.encoder import resolve_device
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.models import adapters as A
from repro_torch.models import model as M
from repro_torch.serve.kvcache import (
    PagedCacheConfig,
    PagedKVCache,
    check_serve_mesh,
    cow_step,
    install_step,
    to_device,
)
from repro_torch.serve.obs import Observability
from repro_torch.serve.scheduler import Request, Scheduler

@dataclasses.dataclass
class ServeConfig:
    """Static-wave server knobs.

    ``prefill_bucket``: quantum (tokens) for power-of-two prompt-length
    bucketing of dense/GQA prefill -- 0 derives it from ``cfg.block``, -1
    disables bucketing (exact prompt shapes).
    """

    max_len: int = 512
    temperature: float = 0.0  # 0 = greedy
    eos_id: Optional[int] = None
    seed: int = 0
    prefill_bucket: int = 0


def bucket_tokens(n: int, block: int) -> int:
    """Round a token count up to a power-of-two number of ``block``-sized
    pages -- the shared shapes of bucketed (dense/GQA) prefill."""
    pages = max(1, math.ceil(n / block))
    return (1 << (pages - 1).bit_length()) * block


# --------------------------------------------------------------------------
# Chunk-shape closure: the chunk lengths chunked admission may run (the
# JAX package's jit signatures; module-level so they can be enumerated
# without an engine).
# --------------------------------------------------------------------------


def resolve_chunk_size(cfg: ModelConfig, page_size: int, requested: int = 0) -> int:
    """Prefill chunk size: page-sized by default, adapter-grid-aligned."""
    grid = A.prefill_chunk_multiple(cfg)
    if requested:
        if requested < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {requested}")
        if requested % grid:
            raise ValueError(
                f"prefill_chunk {requested} must be a multiple of "
                f"the cache adapters' chunk grid {grid}"
            )
        return requested
    return math.lcm(page_size, grid)


def final_chunk_len(cfg: ModelConfig, chunk_size: int, n: int) -> int:
    """Shape of a final (ragged) chunk of ``n`` real tokens: bucketed to the
    next power of two for dense/GQA, exact (capped by the chunk size) where
    semantics require it."""
    if not M.supports_padded_prefill(cfg):
        return n
    return min(bucket_tokens(n, 1), chunk_size)


def chunk_plan(cfg: ModelConfig, chunk_size: int, prompt_len: int,
               cached: int = 0) -> List[int]:
    """The chunk shapes (token lengths) admission runs for a prompt of
    ``prompt_len`` tokens, ``cached`` of them served from the prefix cache
    (chunking resumes at the first uncached token)."""
    plan: List[int] = []
    off = cached
    while off < prompt_len:
        n = min(chunk_size, prompt_len - off)
        last = off + n >= prompt_len
        plan.append(final_chunk_len(cfg, chunk_size, n) if last else chunk_size)
        off += n
    return plan


def chunk_shape_set(cfg: ModelConfig, chunk_size: int) -> tuple:
    """Every chunk length :func:`chunk_plan` can ever emit for this (config,
    chunk size).  Bucketing families: the full chunk plus each power of two
    below it; exact-shape families: every length up to the chunk size."""
    if M.supports_padded_prefill(cfg):
        shapes = {chunk_size}
        p = 1
        while p <= chunk_size:
            shapes.add(p)
            p *= 2
        return tuple(sorted(shapes))
    return tuple(range(1, chunk_size + 1))


def _paged_step(cfg: ModelConfig, params, caches, tokens, seq_pos, page_table, active):
    logits, new_caches = M.decode_step_paged(
        cfg, params, caches, tokens, seq_pos, page_table, active
    )
    # greedy argmax on the device (fp32, as Server._sample): the sampled
    # tokens feed the next step without a host round-trip
    greedy = torch.argmax(logits[:, -1].float(), -1)
    return greedy.to(torch.int32), logits, new_caches


#: the positions of the page-pool argument, which each step writes in place
#: and returns (the JAX package's steps donate it)
_POOL_ARG = (1,)


def step_fns(cfg: ModelConfig) -> Dict[str, tuple]:
    """The continuous engine's hot-path steps: ``{name: (fn, in_place)}``,
    ``in_place`` the positions of the arguments the step writes in place
    and returns.

    Counterpart of the JAX package's ``jitted_step_fns``: the inventory
    :mod:`repro_torch.analysis.torchcheck` traces.  These are the callables
    the engine calls (:class:`Engine` takes its decode and chunk steps from
    here); the install and copy-on-write steps live with the pool they write
    (:func:`repro_torch.serve.kvcache.install_step` /
    :func:`~repro_torch.serve.kvcache.cow_step`).  ``cfg.decode_backend``
    selects the decode and COW route the steps run: the gather oracle
    (``"reference"``) or the CUDA kernels (``"cuda"``).
    """
    return {
        "decode_step": (functools.partial(_paged_step, cfg), _POOL_ARG),
        "prefill_chunk": (functools.partial(M.prefill_chunk, cfg), _POOL_ARG),
        "cow_copy": (cow_step(cfg), (0,)),
        "install": (install_step(cfg), (0,)),
    }


def _extras_on(extras: Dict, device: torch.device) -> Dict:
    """Modality inputs (numpy arrays or tensors) as tensors on ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else to_device(np.asarray(v), device)
            for k, v in extras.items()}


def _check_params_device(params, device: torch.device) -> None:
    where = params["embed"].device
    if where.type != device.type or (device.index is not None and where != device):
        raise ValueError(f"params live on {where}, the engine on {device}; "
                         "create or move them to the engine's device")


def _rank_params(cfg: ModelConfig, params, mesh, device: torch.device):
    """(the parameters the engine runs, its shard policy): the caller's,
    which must live on ``device``, and none; under a mesh, this rank's
    shards (cut from the full tree, which may live anywhere, or a tree the
    serve layout placed), on ``device``, and the serve layout's policy
    where the mesh has several ranks."""
    if mesh is None:
        _check_params_device(params, device)
        return params, None
    layout = SH.ServeLayout(cfg, mesh)
    placed = layout.place(params, device)
    return placed, (layout.policy() if layout.ranks > 1 else None)


class Server:
    """Static-wave batched generation (the single-request parity baseline).

    ``device`` (default ``"cuda"``; raises without CUDA) holds the caches
    and must hold ``params``.  Sampling at ``temperature > 0`` draws from a
    ``torch.Generator`` seeded with ``ServeConfig.seed``: other numbers
    than the JAX package's ``jax.random`` for the same seed.  ``mesh``: a
    ``D x M`` mesh; the rank keeps its shards of the full ``params``, or
    takes a tree its serve layout placed.
    """

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig, mesh=None, device=None):
        self.tp_size = check_serve_mesh(mesh)
        self.cfg, self.sc, self.mesh = cfg, sc, mesh
        self.device = resolve_device(device)
        self.params, self._policy = _rank_params(cfg, params, mesh, self.device)
        self._prefill = functools.partial(M.prefill, cfg)
        self._decode = functools.partial(M.decode_step, cfg)

    def _sample(self, logits, generator):
        logits = logits[:, -1].float()
        if self.sc.temperature <= 0:
            return torch.argmax(logits, -1).to(torch.int32)
        probs = torch.softmax(logits / self.sc.temperature, -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    def _grow_cache(self, caches, batch: int, prompt_len: int):
        """Pad prefill caches out to max_len slots (static decode shapes)."""
        full = M.init_cache(self.cfg, batch, self.sc.max_len, device=self.device,
                            tp_size=self.tp_size)
        for seg, tree in caches.items():
            for key, small_leaves in tree.items():
                for name, small in small_leaves.items():
                    big = full[seg][key][name]
                    big[tuple(slice(0, n) for n in small.shape)] = small.to(big.dtype)
        return full

    def generate(self, batch: Dict, max_new_tokens: int = 32) -> np.ndarray:
        """batch: prompt inputs (tokens (B, S), numpy or a tensor) and any
        frontend extras (an enc-dec config's (B, encoder_seq, d_model)
        ``audio_embeds``; a vision config's (B, n_image, d_model)
        ``vis_embeds`` over the prompt's first n_image tokens and its (3,
        B, S) ``positions3``; stubs where missing, as
        :func:`repro_torch.models.model.frontend_extras` fills them)."""
        with AX.policy(self._policy):
            return self._generate(batch, max_new_tokens)

    def _generate(self, batch: Dict, max_new_tokens: int) -> np.ndarray:
        cfg, sc = self.cfg, self.sc
        tokens = np.asarray(batch["tokens"].cpu() if isinstance(batch["tokens"], torch.Tensor)
                            else batch["tokens"], np.int32)
        B, S = tokens.shape
        assert S + max_new_tokens <= sc.max_len, "increase ServeConfig.max_len"
        extras = M.frontend_extras(
            cfg, _extras_on({k: v for k, v in batch.items() if k != "tokens"}, self.device),
            B, S, self.device)
        if sc.prefill_bucket >= 0 and M.supports_padded_prefill(cfg):
            # bucket the prompt length to power-of-two pages; pad keys are
            # causally masked during prefill and overwritten by decode before
            # their position label becomes reachable, so the logits at
            # last_idx = S - 1 (and everything after) match the exact shape
            quantum = sc.prefill_bucket or cfg.block
            Sp = min(bucket_tokens(S, quantum), sc.max_len)
            padded = np.zeros((B, Sp), np.int32)
            padded[:, :S] = tokens
            logits, caches = self._prefill(
                self.params, {"tokens": to_device(padded, self.device), **extras}, S - 1)
        else:
            logits, caches = self._prefill(
                self.params, {"tokens": to_device(tokens, self.device), **extras})
        caches = self._grow_cache(caches, B, S)
        generator = torch.Generator(device=self.device).manual_seed(sc.seed)
        out = []
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        tok = self._sample(logits, generator)
        for i in range(max_new_tokens):
            out.append(tok)
            if sc.eos_id is not None:
                done = done | (tok == sc.eos_id)
                if bool(done.all()):
                    break
            logits, caches = self._decode(self.params, caches, tok[:, None], S + i)
            tok = self._sample(logits, generator)
        return torch.stack(out, dim=1).cpu().numpy()


# --------------------------------------------------------------------------
# Continuous batching over the block-paged cache
# --------------------------------------------------------------------------

@dataclasses.dataclass
class EngineConfig:
    """Continuous-batching engine knobs (those of the JAX package).

    ``page_size=0`` derives the page from ``cfg.block`` (the accelerator
    kernel block governs the cache arrangement); ``num_pages=0`` sizes the
    pool for ``max_seqs`` full-length sequences.

    ``prefill_chunk=0`` derives the chunk from the page size (one chunk =
    one page of tokens), lifted onto each adapter's chunk grid.

    ``prefill_tokens_per_step`` is the admission budget: how many prompt
    *tokens* may run per engine step before the decode batch steps, spent
    page-granularly.  ``0`` derives it from the DEPRECATED chunk-count alias
    ``prefill_chunks_per_step`` (budget = chunks x chunk size); setting the
    alias explicitly emits a one-shot ``DeprecationWarning`` (leave it None
    for the default of 4 chunks).

    ``chunked_prefill=False`` falls back to one-shot prefill per admission,
    installed into the pool in place.

    ``prefix_sharing`` lets requests with a common page-aligned token
    prefix alias the same physical pages (radix prefix index + refcounts +
    copy-on-write divergence).

    ``backend`` selects the paged-decode execution path
    (:func:`repro_torch.core.backend.resolve_backend` name): ``"cuda"``
    streams pages through the paged-attention / paged-copy kernels (their
    plain versions for CPU tensors); ``"reference"`` keeps the gather ->
    attend decode and the sliced COW copy.  Folded into
    ``cfg.decode_backend``.
    """

    max_seqs: int = 4
    max_len: int = 128  # per-request capacity (prompt + generation)
    page_size: int = 0
    num_pages: int = 0
    chunked_prefill: bool = True
    prefill_chunk: int = 0
    prefill_tokens_per_step: int = 0  # 0: derive from the deprecated alias
    prefill_chunks_per_step: Optional[int] = None  # DEPRECATED alias
    prefix_sharing: bool = True
    backend: str = "cuda"  # paged-decode path: cuda | reference
    temperature: float = 0.0  # 0 = greedy
    eos_id: Optional[int] = None
    seed: int = 0
    # run the PagedKVCache refcount auditor after every step
    debug_audit: bool = False
    # deep observability: spans/counters/cheap gauges are always on (host
    # int bookkeeping at scheduling events -- cannot change outputs); this
    # additionally runs the pool audit every step and wraps the decode/chunk
    # dispatches in torch.profiler.record_function ranges
    obs: bool = False


_DEFAULT_CHUNKS_PER_STEP = 4  # the alias's historical default

_chunks_alias_warned = False


def warn_prefill_chunks_deprecated() -> None:
    """One-shot DeprecationWarning for the ``prefill_chunks_per_step``
    chunk-count alias (per process; the launch driver and EngineConfig
    consumers both funnel through here)."""
    global _chunks_alias_warned
    if _chunks_alias_warned:
        return
    _chunks_alias_warned = True
    warnings.warn(
        "prefill_chunks_per_step is deprecated: the admission budget is "
        "token-level now — set prefill_tokens_per_step (the chunk-count "
        "alias still maps to chunks x chunk size, but will be removed)",
        DeprecationWarning,
        stacklevel=3,
    )


class Engine:
    """Continuous-batching serving engine (scheduler + paged KV cache).

    ``device`` (default ``"cuda"``; raises without CUDA) holds the page
    pool and must hold ``params``.  ``mesh``: a ``D x M`` mesh; the rank
    keeps its shards of the full ``params`` (which may then live on any
    device), or takes a tree its serve layout placed, and holds its share
    of the pools.  A kv-head count the model axis does not divide raises
    before anything is allocated.
    """

    def __init__(self, cfg: ModelConfig, params, ec: EngineConfig, mesh=None,
                 device=None):
        check_serve_mesh(mesh)
        # fold the backend selector into the frozen config; resolve eagerly
        # so an unknown name fails here, not mid-step
        resolve_backend(ec.backend)
        if ec.backend != cfg.decode_backend:
            cfg = dataclasses.replace(cfg, decode_backend=ec.backend)
        self.cfg, self.ec, self.mesh = cfg, ec, mesh
        self.device = resolve_device(device)
        self.params, self._policy = _rank_params(cfg, params, mesh, self.device)
        # recompute families rely on prefix chunks replaying the publisher's
        # exact chunk grid; one-shot prefill groups the whole prompt per
        # request, so sharing is only sound there for compute-skippable
        # families (unsupported families are refused by PagedKVCache)
        sharing = ec.prefix_sharing and (
            ec.chunked_prefill or A.prefix_compute_skippable(cfg)
        )
        self.kv = PagedKVCache(cfg, PagedCacheConfig(
            max_seqs=ec.max_seqs, max_len=ec.max_len,
            page_size=ec.page_size, num_pages=ec.num_pages,
            prefix_sharing=sharing,
        ), mesh=mesh, device=self.device)
        self.obs = Observability(deep=ec.obs, max_seqs=ec.max_seqs)
        self.sched = Scheduler(self.kv, ec.max_seqs, obs=self.obs)
        self.chunk_size = resolve_chunk_size(cfg, self.kv.page_size, ec.prefill_chunk)
        if ec.prefill_tokens_per_step < 0:
            raise ValueError("prefill_tokens_per_step must be >= 0")
        chunks_alias = ec.prefill_chunks_per_step
        if chunks_alias is None:
            chunks_alias = _DEFAULT_CHUNKS_PER_STEP
        else:
            warn_prefill_chunks_deprecated()
        if ec.prefill_tokens_per_step == 0 and chunks_alias < 1:
            raise ValueError("prefill_chunks_per_step must be >= 1")
        self.tokens_per_step = (
            ec.prefill_tokens_per_step or chunks_alias * self.chunk_size
        )
        # adapters installing request-level context once at admission
        # (enc-dec encoder K/V) -- resolved from the registry, not by family
        self._admission_ads = A.admission_adapters(cfg)
        self._prefill = functools.partial(M.prefill, cfg)
        steps = step_fns(cfg)
        self._chunk_fn = steps["prefill_chunk"][0]
        self._decode = steps["decode_step"][0]
        # per-slot last sampled token, kept ON DEVICE: the greedy loop feeds
        # decode outputs straight back in, syncing to host only at
        # scheduling events (finish, preemption, EOS, temperature sampling)
        self._last_tok = torch.zeros((ec.max_seqs,), dtype=torch.int32, device=self.device)
        # deferred token log: (device (B,) greedy tokens, [(slot, req), ...])
        self._pending: List[tuple] = []
        self._rid_counter = 0
        self.step_count = 0
        self.decode_steps = 0
        self.prefill_tokens = 0
        self.prefill_chunks = 0  # chunk steps actually run (sharing skips)

    # -- request intake -----------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *, rid: Optional[int] = None,
               arrival_step: int = 0, extras: Optional[Dict] = None) -> Request:
        """``extras``: per-request modality inputs beyond the token prompt
        (an enc-dec config's (1, encoder_seq, d_model) ``audio_embeds``,
        numpy or a tensor).  Missing entries are stub-filled at prefill
        time, as in the static-wave baseline; extras survive preemption
        (re-admission re-runs the encoder)."""
        if rid is None:
            rid = self._rid_counter
        self._rid_counter = max(self._rid_counter, rid) + 1
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      arrival_step=arrival_step, extras=extras)
        self.sched.submit(req)
        return req

    def _extras_batch(self, req: Request) -> Dict:
        """The request's modality inputs on the device, stub-filled where
        missing."""
        return M.frontend_extras(self.cfg, _extras_on(req.extras or {}, self.device), 1,
                                 len(req.prompt), self.device)

    # -- sampling -----------------------------------------------------------

    def _sample(self, row_logits: torch.Tensor, req: Request) -> int:  # repro: hot-loop
        """Sample one token from a (V,) logits row (fp32, greedy or temp)."""
        lf = row_logits.float()
        if self.ec.temperature <= 0:
            # callers that can defer use the on-device greedy feedback path,
            # not _sample -- this sync only runs at scheduling events
            return int(torch.argmax(lf))  # repro: noqa RPR002 -- sanctioned sync: first token
        # per-request, per-position generator: independent of scheduling order
        seed = (self.ec.seed * 1_000_003 + req.rid) * 1_000_003 + len(req.out_tokens)
        gen = torch.Generator(device=lf.device).manual_seed(seed % (1 << 63))
        probs = torch.softmax(lf / self.ec.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=gen))  # repro: noqa RPR002 -- sanctioned sync: sampling

    def _append_token(self, slot: int, req: Request, tok: int) -> None:
        req.out_tokens.append(tok)
        # out of place: the previous tensor may be a logged greedy row
        last = self._last_tok.clone()
        last[slot] = tok
        self._last_tok = last
        if req.done or (self.ec.eos_id is not None and tok == self.ec.eos_id):
            self.sched.finish(slot, self.step_count)

    def _flush_pending(self) -> None:  # repro: hot-loop
        """Materialize the deferred on-device tokens into out_tokens: one
        device->host copy for every step since the last flush."""
        if not self._pending:
            return
        rows = torch.stack([g for g, _ in self._pending]).cpu().numpy()  # repro: noqa RPR006 -- sanctioned sync: flush
        for row, (_, running) in zip(rows, self._pending):
            for slot, req in running:
                req.out_tokens.append(int(row[slot]))  # repro: noqa RPR002 -- host ndarray
                req.n_pending -= 1
        self._pending.clear()

    # -- prefill ------------------------------------------------------------

    def _install_admission_context(self, slot: int, req: Request) -> None:
        """Run the registry's admission-time installs for a fresh slot
        (enc-dec: one encoder pass -> immutable cross rows).  Happens again
        after a preemption: recompute discipline."""
        for ad in self._admission_ads:
            src = ad.admission_src(self.cfg, self.params, self._extras_batch(req))
            self.kv.install_partial(slot, src)

    def _prefill_one_chunk(self, slot: int, req: Request) -> int:  # repro: hot-loop
        """Feed the next chunk of a slot's prompt through the paged caches,
        in place, and on the final chunk sample the request's first token.
        Returns the number of real prompt tokens consumed (the admission
        budget's unit)."""
        prompt = req.effective_prompt
        off = req.prefill_pos
        n = min(self.chunk_size, len(prompt) - off)
        # the final ragged chunk is bucketed (bounded by the chunk size)
        n_pad = final_chunk_len(self.cfg, self.chunk_size, n) if off + n >= len(prompt) else n
        toks = np.zeros((1, n_pad), np.int32)
        toks[0, :n] = prompt[off : off + n]
        phys_tok, off_tok = self.kv.token_targets(slot, off, n_pad)
        self.obs.chunk_begin(req, self.step_count, off, n)
        with self.obs.device_span("prefill_chunk"):
            logits, self.kv.data = self._chunk_fn(
                self.params, self.kv.data, to_device(toks, self.device), slot,
                off, phys_tok, off_tok, self.kv.table_row(slot), n - 1,
            )
        req.prefill_pos += n
        self.prefill_tokens += n
        self.prefill_chunks += 1
        self.obs.chunk_end(req, self.step_count)
        # publish newly completed full pages: from here on, prompts sharing
        # this prefix alias these pages instead of recomputing them
        self.kv.commit_prefix(slot, prompt, req.prefill_pos)
        if not req.prefilling:  # final chunk: sample the first token
            # close the prefill span / open decode BEFORE sampling: with
            # max_new == 1 the sampled token finishes the request
            self.obs.prefill_complete(req, self.step_count)
            self._append_token(slot, req, self._sample(logits[0, -1], req))
        return n

    def _prefill_full(self, slot: int, req: Request) -> None:
        """One-shot prefill + in-place install (unchunked path)."""
        prompt = req.effective_prompt
        S = len(prompt)
        extras = self._extras_batch(req)
        if M.supports_padded_prefill(self.cfg):
            # clamp to the per-slot capacity: positions past max_len can
            # never be used
            Sp = min(bucket_tokens(S, self.kv.page_size), self.kv.max_len)
            toks = np.zeros((1, Sp), np.int32)
            toks[0, :S] = prompt
            with self.obs.device_span("prefill_full"):
                logits, caches = self._prefill(
                    self.params, {"tokens": to_device(toks, self.device), **extras}, S - 1)
        else:
            with self.obs.device_span("prefill_full"):
                logits, caches = self._prefill(
                    self.params, {"tokens": to_device(prompt[None], self.device), **extras})
        self.kv.install_prefill(slot, caches)
        req.prefill_pos = req.prefill_target
        self.prefill_tokens += S
        self.kv.commit_prefix(slot, prompt, S)
        self.obs.prefill_complete(req, self.step_count)
        self._append_token(slot, req, self._sample(logits[0, -1], req))

    # -- engine steps -------------------------------------------------------

    def _admit_and_prefill(self) -> None:  # repro: hot-loop
        admitted = self.sched.admit(self.step_count)
        if not self.ec.chunked_prefill:
            for slot, req in admitted:
                self._prefill_full(slot, req)
            return
        # request-level admission context (enc-dec encoder K/V) installs at
        # admission, not on the first chunk
        for slot, req in admitted:
            self._install_admission_context(slot, req)
        # token budget, oldest admission first (FIFO toward first token);
        # whatever is left waits for the next engine step, with the decode
        # batch stepping in between.  Spending is page-granular: a chunk may
        # start while any budget remains.
        budget = self.tokens_per_step
        for slot, req in self.sched.prefilling:
            while budget > 0 and req.prefilling:
                budget -= self._prefill_one_chunk(slot, req)
            if budget <= 0:
                break

    def _decode_once(self) -> None:  # repro: hot-loop
        decoding = self.sched.decoding
        deficit = sum(
            self.kv.growth_deficit(slot, req.next_pos) for slot, req in decoding
        ) if decoding else 0
        if deficit > self.kv.num_free_pages and deficit > self.kv.available_pages:
            # the growth round below may preempt: victims must carry their
            # full token history back to the queue, so sync first
            self._flush_pending()
        self.sched.grow_for_decode(self.step_count)
        decoding = self.sched.decoding
        self.obs.decode_batch(len(decoding))
        if not decoding:
            return
        seq_pos = np.zeros((self.ec.max_seqs,), np.int32)  # idle slots -> 0
        active = np.zeros((self.ec.max_seqs,), bool)  # idle/prefilling: False
        for slot, req in decoding:
            seq_pos[slot] = req.next_pos
            active[slot] = True
        with self.obs.device_span("decode_step"):
            greedy, logits, self.kv.data = self._decode(
                self.params, self.kv.data, self._last_tok[:, None],
                to_device(seq_pos, self.device), self.kv.page_table(),
                to_device(active, self.device),
            )
        self.decode_steps += 1
        if self.ec.temperature > 0:
            # host sampling needs the logits now -- no deferral on this path
            for slot, req in decoding:
                self._append_token(slot, req, self._sample(logits[slot, -1], req))
            return
        self._last_tok = greedy  # feed back on-device; no host round-trip
        self._pending.append((greedy, decoding))
        for slot, req in decoding:
            req.n_pending += 1
        if self.ec.eos_id is not None:
            # early-stop decisions need token values every step
            self._flush_pending()
            for slot, req in decoding:
                if req.state == "running" and (
                    req.done or req.out_tokens[-1] == self.ec.eos_id
                ):
                    self.sched.finish(slot, self.step_count)
            return
        # max_new completion is pure length bookkeeping: no sync needed
        for slot, req in decoding:
            if req.done:
                self.sched.finish(slot, self.step_count)

    def step(self) -> None:  # repro: hot-loop
        """One engine iteration: arrivals -> admissions (prefill) -> decode
        (under the mesh's shard policy, if any)."""
        t0 = self.obs.step_begin()
        self.sched.poll_arrivals(self.step_count)
        with AX.policy(self._policy):
            self._admit_and_prefill()
            self._decode_once()
        self.step_count += 1
        audit = None
        if self.ec.debug_audit or self.obs.deep:
            audit = self.kv.audit()
        self.obs.step_end(self, t0, audit)

    def run(self, max_steps: int = 1_000_000) -> List[Request]:
        """Drive until every submitted request finishes; returns the
        requests that finished during THIS call (rid order, stats
        populated) -- a reused engine doesn't re-report earlier batches."""
        already = set(self.sched.finished)
        while self.sched.has_work():
            if self.step_count >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
            self.step()
        self._flush_pending()
        return [
            self.sched.finished[rid]
            for rid in sorted(set(self.sched.finished) - already)
        ]

    # -- convenience --------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """JSON-ready snapshot of the engine's metrics registry."""
        return self.obs.registry.snapshot()

    def export_trace(self, path: str) -> Dict[str, Any]:
        """Write the recorded spans as Chrome-trace JSON (Perfetto-loadable)
        to ``path``; returns the trace object."""
        return self.obs.export_chrome_trace(path)

    def generate(self, batch: Dict, max_new_tokens: int = 32) -> np.ndarray:
        """Drop-in for Server.generate: all prompts arrive at step 0.
        Non-token batch entries with a leading batch axis (enc-dec
        ``audio_embeds``) are split into per-request extras.  With
        ``eos_id`` set, requests that stop early are right-padded with the
        eos token so the result stays rectangular."""
        tokens = batch["tokens"]
        tokens = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor) else tokens)
        for b in range(tokens.shape[0]):
            extras = {k: v[b:b + 1] for k, v in batch.items() if k != "tokens"}
            self.submit(tokens[b], max_new_tokens, extras=extras or None)
        reqs = self.run()
        pad = self.ec.eos_id if self.ec.eos_id is not None else 0
        out = np.full((len(reqs), max_new_tokens), pad, np.int32)
        for i, r in enumerate(reqs):
            toks = r.out_tokens[:max_new_tokens]
            out[i, : len(toks)] = toks
        return out


def run_static_waves(
    server: Server, requests: Sequence[dict], max_seqs: int
) -> Dict[int, np.ndarray]:
    """Drive the static-wave :class:`Server` over a multi-request workload.

    Requests are grouped in arrival order into waves of ``max_seqs``; each
    wave prefills together and decodes in lockstep for the wave's
    **longest** generation length, and the next wave waits for the drain.
    Requests must share one prompt length; a request's ``extras`` (each
    entry with a leading batch axis of 1) join its wave's batch.  Returns
    {rid: generated tokens, trimmed to the request's own
    ``max_new_tokens``}.
    """
    order = sorted(requests, key=lambda r: (r["arrival_step"], r["rid"]))
    lens = {len(r["prompt"]) for r in order}
    if len(lens) > 1:
        raise ValueError(f"static waves need one prompt length, got {sorted(lens)}")
    outs: Dict[int, np.ndarray] = {}
    for w in range(0, len(order), max_seqs):
        wave = order[w : w + max_seqs]
        batch = {"tokens": np.stack([r["prompt"] for r in wave])}
        for k in wave[0].get("extras") or {}:
            batch[k] = np.concatenate([np.asarray(r["extras"][k]) for r in wave])
        out = server.generate(batch, max(r["max_new_tokens"] for r in wave))
        for r, row in zip(wave, out):
            outs[r["rid"]] = np.asarray(row[: r["max_new_tokens"]], np.int32)
    return outs


def make_requests(
    vocab_size: int,
    num_requests: int,
    *,
    prompt_len: int = 16,
    max_new: int = 32,
    mean_interarrival: float = 0.0,
    vary_lengths: bool = True,
    seed: int = 0,
) -> List[dict]:
    """Deterministic 'Poisson-ish' smoke workload: exponential inter-arrival
    gaps (in decode-step units) and per-request generation lengths, all from
    one seeded numpy generator (the JAX package's workload, number for
    number).  Returns plain dicts so both engines can consume."""
    rng = np.random.default_rng(seed)
    reqs, step = [], 0
    for i in range(num_requests):
        if i and mean_interarrival > 0:
            step += int(rng.exponential(mean_interarrival))
        # generation lengths spread over [2, max_new]: realistic serving
        # traffic is length-heterogeneous, which is precisely what lockstep
        # waves pay for and slot re-fill does not
        n_new = (
            int(rng.integers(2, max_new + 1)) if vary_lengths else max_new
        )
        reqs.append({
            "rid": i,
            "prompt": rng.integers(0, vocab_size, size=(prompt_len,)).astype(np.int32),
            "max_new_tokens": n_new,
            "arrival_step": step,
        })
    return reqs
