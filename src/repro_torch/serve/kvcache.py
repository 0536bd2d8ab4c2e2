"""Block-paged KV-cache manager: the paper's arrangement applied to serving.

Counterpart of ``repro.serve.kvcache``.  The paper's thesis is that data
should live in memory in the units the accelerator kernel consumes.  During
decode the dominant traffic is the KV cache, so this module stores it as
**pages** of ``page_size`` token slots, where ``page_size`` defaults to the
accelerator kernel block (``cfg.block``) -- one page is exactly the region
the paged-decode kernel streams per step.  Physical pages live in one pool
per layer and are handed to requests through:

* a **reference-counted free-list allocator** (page 0 is reserved as the
  null page -- the write target for idle batch slots and the gather target
  for unmapped entries); pages are shared by aliasing, so ``ref``/``unref``
  replace a raw ``free``,
* **per-request page tables** mapping logical pages (position // page_size)
  to physical pages,
* a **radix prefix index** (:class:`PrefixIndex`) keyed on page-aligned
  token prefixes: admission aliases a prompt's longest cached prefix
  (refcount + 1 per page) and chunk-prefills only the uncached suffix.  A
  decode write into a page whose refcount is > 1 triggers **copy-on-write**
  (:meth:`PagedKVCache.prepare_decode_write`).  Prefix pages are freed LRU,
  and only when the free list is exhausted (:meth:`PrefixIndex.evict_lru`).

What a page of context *is* per layer family is the family's
:class:`~repro_torch.models.adapters.CacheAdapter`'s business; this module
owns the pool geometry, the page accounting, the prefix index, and the
install/copy steps that walk the adapter registry.

Host-side bookkeeping (free list, page tables, per-slot lengths) is numpy.
The device pools are the tensors :func:`repro_torch.models.model.init_paged_cache`
allocates once; where the JAX package jits its install and COW steps with
the pool donated, this port updates the pool tensors in place, eagerly --
the pool is never copied.

Under a ``D x M`` mesh (``mesh=``) each rank allocates its share of every
pool as the adapters' ``pool_pspecs`` place it over the model axis
(kv-head-sharded K/V pages, ring and cross rows; whole MLA latent pages and
SSM rows), replicated over the data axis as in the JAX package: the ``D``
ranks of a model slice hold the same kv heads and write the same values.
The page tables, free lists, refcounts and prefix index are host state
that every rank computes identically from the same schedule, so a page id
names the same page of every rank's shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core.encoder import resolve_device
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.models import adapters as A
from repro_torch.models import model as M

NULL_PAGE = 0  # reserved physical page: idle-slot writes, unmapped gathers

def check_serve_mesh(mesh) -> int:
    """The model-axis size of a serving mesh (1 without one).  Raises
    ``TypeError`` for an object that is not a mesh (or an abstract one of
    several ranks) and ``ValueError`` for axes other than ``("data",
    "model")``."""
    if mesh is None:
        return 1
    if not AX.is_mesh(mesh):
        raise TypeError(f"mesh must be a DeviceMesh named ('data', 'model') (see "
                        f"repro_torch.launch.mesh.make_serve_mesh), got {type(mesh).__name__}")
    shape = AX.mesh_shape(mesh)
    if set(shape) != {"data", "model"}:
        raise ValueError(f"a serving mesh has the axes ('data', 'model'), not "
                         f"{AX.mesh_names(mesh)}")
    if isinstance(mesh, AX.AbstractMesh) and math.prod(shape.values()) > 1:
        raise TypeError("an abstract mesh has no ranks to serve on; build the mesh with "
                        "repro_torch.launch.mesh.make_serve_mesh over a process group")
    return shape["model"]


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a small host array without a device sync: from pinned host
    memory, asynchronously, on CUDA (a blocking copy from pageable memory
    would wait for every queued kernel); a copy on the CPU."""
    t = torch.from_numpy(np.array(x, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload_into(dst: torch.Tensor, x) -> torch.Tensor:
    """Copy a small host array (or a tensor) into ``dst`` in place: from
    pinned host memory, asynchronously, on CUDA, as :func:`to_device`
    uploads, so ``dst`` keeps its storage and nothing syncs."""
    if isinstance(x, torch.Tensor):
        return dst.copy_(x)
    t = torch.from_numpy(np.ascontiguousarray(x)).reshape(dst.shape)
    if dst.is_cuda:
        return dst.copy_(t.pin_memory(), non_blocking=True)
    return dst.copy_(t)


# The slot-write updater of the unchunked admission path: every slot write
# (the paged scatter of a one-shot prefill cache) walks the adapter
# registry and lands in the pool tensors in place -- where the JAX package
# jits this step and donates the pool, so that no admission copies it.
def install_step(cfg: ModelConfig):
    def install(data, src, slot, phys_tok, off_tok):
        for si, (kind, _n) in enumerate(M.layer_segments(cfg)):
            seg = f"seg{si}"
            if seg not in src:
                continue  # untouched (partial install)
            for ad in A.adapters_for(cfg, kind):
                if ad.key in src[seg]:
                    ad.install(cfg, data[seg][ad.key], src[seg][ad.key], slot,
                               phys_tok, off_tok)
        return data

    return install


# The COW page copier: copies physical page ``src`` -> ``dst`` in every
# shareable paged pool, in place -- the copy-on-write of one page never
# copies (or even briefly doubles) the pool.
def cow_step(cfg: ModelConfig):
    """The COW page-copy step.

    Copies ``src`` -> ``dst`` in every *shareable paged* adapter's pools;
    other pools pass through untouched.  Each adapter's ``copy_page``
    dispatches on ``cfg.decode_backend``: the reference path is a sliced
    copy, the cuda path the paged-copy kernel (one launch per pool); both
    are bit-exact and write the pool in place.
    """
    def copy(data, src: int, dst: int):
        for si, (kind, _n) in enumerate(M.layer_segments(cfg)):
            seg = f"seg{si}"
            for ad in A.adapters_for(cfg, kind):
                if ad.paged and ad.shareable:
                    ad.copy_page(cfg, data[seg][ad.key], src, dst)
        return data

    return copy


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Sizing of the paged cache pool.

    ``page_size=0`` derives the page from the accelerator kernel block
    (``cfg.block``) — the paper's 'governed by the kernel size'.
    ``num_pages=0`` sizes the pool so every slot can reach ``max_len``
    (plus the null page); smaller values exercise admission control and
    preemption.
    """

    max_seqs: int = 4
    max_len: int = 128  # per-sequence token capacity (rounded up to pages)
    page_size: int = 0
    num_pages: int = 0
    # physical pages may be aliased across requests sharing a token prefix
    # (only effective for families the registry declares shareable)
    prefix_sharing: bool = True


class PageAllocator:
    """Refcounted free-list allocator over physical page ids [1, num_pages).

    A page is handed out by :meth:`alloc` with refcount 1; sharing a page
    across requests (or pinning it in the prefix index) takes another
    reference via :meth:`ref`, and :meth:`unref` replaces a raw free — the
    page returns to the free list only when its last reference drops.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one real + null page)")
        self.num_pages = num_pages
        # LIFO free list: recently released (hot) pages are reused first
        self._free: List[int] = list(range(num_pages - 1, NULL_PAGE, -1))
        self._ref = [0] * num_pages  # per-page reference count
        self.pages_allocated = 0  # cumulative allocs (sharing saves these)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages at refcount 1, or None (and no change) if the
        pool is short."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for p in got:
            self._ref[p] = 1
        self.pages_allocated += n
        return got

    def ref(self, pages: List[int]) -> None:
        """Take one more reference on live pages (aliasing / index pin)."""
        for p in pages:
            if not (NULL_PAGE < p < self.num_pages):
                raise ValueError(f"ref of invalid page id {p}")
            if self._ref[p] < 1:
                raise ValueError(f"ref of free page {p}")
        for p in pages:
            self._ref[p] += 1

    def unref(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; pages reaching zero return to the
        free list.  Returns the pages actually freed."""
        for p in pages:
            if not (NULL_PAGE < p < self.num_pages):
                raise ValueError(f"unref of invalid page id {p}")
            if self._ref[p] < 1:
                raise ValueError(f"unref of free page {p} (double free)")
        freed = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed


class _PrefixNode:
    """One page-aligned token page in the radix prefix index."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key, page, parent, now):
        self.key = key  # tuple of page_size token ids
        self.page = page  # physical page holding these tokens' cache
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.parent: Optional["_PrefixNode"] = parent
        self.last_used = now


class PrefixIndex:
    """Radix/trie index of cached prompt prefixes, one node per full page.

    Keys are **page-aligned token prefixes**: a node at depth d holds the
    physical page caching tokens ``[d * page_size, (d+1) * page_size)`` of
    every prompt that reaches it.  The index owns one reference on each of
    its pages (taken at :meth:`insert`), so a cached prefix survives the
    requests that built it and is reclaimed **LRU, leaf-first** only when
    the allocator's free list is exhausted (:meth:`evict_lru`) — exactly
    the paper's discipline of keeping hot arranged data resident and
    spilling cold data only under pressure.
    """

    def __init__(self, page_size: int, allocator: PageAllocator):
        self.page_size = page_size
        self.allocator = allocator
        self._root: Dict[tuple, _PrefixNode] = {}
        self._clock = 0
        self._n_nodes = 0

    @property
    def num_pages(self) -> int:
        return self._n_nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: (physical pages, matched
        token count).

        Matches whole pages while the walk holds, then — only when the
        prompt's remaining tail is shorter than a page — one partially-
        consumed child whose key *starts with* the entire tail.  A partial
        match therefore always covers the prompt to its end (matched ==
        len(tokens)): the suffix left to prefill either starts at a page
        boundary or is empty, never mid-page.
        """
        toks = np.asarray(tokens)
        n, ps = len(toks), self.page_size
        now = self._tick()
        pages: List[int] = []
        matched = 0
        children = self._root
        while matched + ps <= n:
            key = tuple(int(t) for t in toks[matched : matched + ps])
            node = children.get(key)
            if node is None:
                break
            node.last_used = now
            pages.append(node.page)
            matched += ps
            children = node.children
        tail = tuple(int(t) for t in toks[matched:])
        if 0 < len(tail) < ps and matched + len(tail) == n:
            for key, node in children.items():
                if key[: len(tail)] == tail:
                    node.last_used = now
                    pages.append(node.page)
                    matched += len(tail)
                    break
        return pages, matched

    def insert(self, tokens: np.ndarray, pages: List[int], n_tokens: int) -> None:
        """Publish the full pages covering ``tokens[:n_tokens]``.

        Walks the tree along the token path; existing nodes are kept (the
        first publisher of a prefix wins — a concurrent recompute's
        duplicate pages simply stay private to their slot), new nodes pin
        their page with one index-owned reference.
        """
        toks = np.asarray(tokens)
        ps = self.page_size
        now = self._tick()
        children, parent = self._root, None
        for pi in range(min(n_tokens, len(toks)) // ps):
            key = tuple(int(t) for t in toks[pi * ps : (pi + 1) * ps])
            node = children.get(key)
            if node is None:
                self.allocator.ref([pages[pi]])
                node = _PrefixNode(key, pages[pi], parent, now)
                children[key] = node
                self._n_nodes += 1
            else:
                node.last_used = now
            children, parent = node.children, node

    def _walk(self):
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def evict_lru(self) -> Optional[int]:
        """Free the least-recently-used evictable page (leaf node whose
        page only the index still references).  Returns the freed page id,
        or None when nothing is evictable."""
        best = None
        for node in self._walk():
            if node.children or self.allocator.refcount(node.page) != 1:
                continue
            if best is None or node.last_used < best.last_used:
                best = node
        if best is None:
            return None
        siblings = best.parent.children if best.parent else self._root
        del siblings[best.key]
        self._n_nodes -= 1
        self.allocator.unref([best.page])
        return best.page

    def reclaimable_count(self, exclude=()) -> int:
        """Pages :meth:`evict_lru` could eventually free right now: nodes
        held only by the index whose whole subtree is likewise evictable
        (eviction is leaf-first, so a pinned descendant shields its
        ancestors).  ``exclude``: pages about to be aliased — they must not
        be counted as reclaimable by the very admission that needs them."""
        exclude = set(exclude)

        def rec(node) -> Tuple[bool, int]:
            ok_below, count = True, 0
            for c in node.children.values():
                ok, n = rec(c)
                ok_below &= ok
                count += n
            ok = (ok_below and node.page not in exclude
                  and self.allocator.refcount(node.page) == 1)
            return ok, count + (1 if ok else 0)

        return sum(rec(n)[1] for n in self._root.values())


class PagedKVCache:
    """Device cache pool + host page tables for the continuous-batching engine.

    The pools live on ``device`` (default ``"cuda"``; raises without CUDA).
    ``mesh``: a ``D x M`` mesh (:func:`check_serve_mesh`); the rank then
    holds its share of the pools (1/M of a head-sharded one).
    """

    def __init__(self, cfg: ModelConfig, pc: PagedCacheConfig, mesh=None, device=None):
        tp_size = check_serve_mesh(mesh)
        msg = A.unsupported_message(cfg, hint="use Server for the rest")
        if msg is not None:
            raise NotImplementedError(msg)
        self.cfg = cfg
        self.mesh = mesh
        self.tp_size = tp_size
        self.device = resolve_device(device)
        self.page_size = pc.page_size or cfg.block
        self.max_seqs = pc.max_seqs
        self.max_pages_per_seq = max(1, math.ceil(pc.max_len / self.page_size))
        self.max_len = self.max_pages_per_seq * self.page_size
        num_pages = pc.num_pages or (pc.max_seqs * self.max_pages_per_seq + 1)
        self.allocator = PageAllocator(num_pages)
        # prefix sharing is a per-family capability: pages must be position-
        # indexed pure functions of the token prefix to be aliased at all,
        # and every adapter must be shareable (and MoE absent) before the
        # prefix's prefill chunks may be skipped rather than recomputed
        self.sharing = pc.prefix_sharing and A.prefix_shareable(cfg)
        self.skip_prefill = self.sharing and A.prefix_compute_skippable(cfg)
        self.index = (
            PrefixIndex(self.page_size, self.allocator) if self.sharing else None
        )
        self.data = M.init_paged_cache(
            cfg, pc.max_seqs, num_pages, self.page_size, self.max_len, device=self.device,
            tp_size=tp_size,
        )
        # where each pool leaf lies on the mesh: the adapters' specs
        self._specs = SH.paged_cache_pspecs(cfg, mesh, self.data) if mesh is not None else None
        self._install = install_step(cfg)
        self._cow = cow_step(cfg)
        # host-side page tables; unmapped entries point at the null page
        self._table = np.zeros((pc.max_seqs, self.max_pages_per_seq), np.int32)
        # its device mirror: one buffer for the pool's life (a captured
        # decode step reads it), refreshed in place when a row changed
        self._table_dev = torch.zeros(self._table.shape, dtype=torch.int32,
                                      device=self.device)
        self._table_dirty = False
        self._pages: Dict[int, List[int]] = {}  # slot -> physical pages
        self._cached_tokens: Dict[int, int] = {}  # slot -> aliased prefix len
        self.pages_aliased = 0  # cumulative prefix-page aliases (stats)
        self.cow_copies = 0  # cumulative copy-on-write page copies (stats)

    # -- accounting ---------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    @property
    def num_free_pages(self) -> int:
        return self.allocator.num_free

    @property
    def available_pages(self) -> int:
        """Pages obtainable right now: the free list plus whatever LRU
        eviction of unreferenced prefix pages could reclaim."""
        extra = self.index.reclaimable_count() if self.index else 0
        return self.allocator.num_free + extra

    @property
    def prefix_cache_pages(self) -> int:
        """Physical pages currently pinned by the prefix index."""
        return self.index.num_pages if self.index else 0

    def pool_stats(self) -> Dict[str, int]:  # repro: hot-loop
        """O(1) host-int pool stats, cheap enough for every engine step."""
        return {
            "pages_total": self.allocator.num_pages - 1,  # excl. null page
            "pages_free": self.allocator.num_free,
            "prefix_cache_pages": self.prefix_cache_pages,
            "pages_aliased_total": self.pages_aliased,
            "cow_copies_total": self.cow_copies,
            "pages_allocated_total": self.allocator.pages_allocated,
        }

    def _lookup(self, prompt) -> Tuple[List[int], int, int]:
        """(cached prefix pages, matched tokens, prompt length).  ``prompt``
        may be a bare length (no sharing) or the token array the prefix
        index needs."""
        if isinstance(prompt, (int, np.integer)):
            return [], 0, int(prompt)
        prompt = np.asarray(prompt)
        if self.index is None:
            return [], 0, len(prompt)
        pages, matched = self.index.lookup(prompt)
        if not self.skip_prefill and matched % self.page_size:
            # recompute families may alias only full pages (the JAX
            # package's MoE regroup caveat); clamp to the full-page walk
            pages = pages[:-1]
            matched -= matched % self.page_size
        return pages, matched, len(prompt)

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Allocate with fallback: prefix pages are evicted LRU only when
        the free list is exhausted."""
        while self.allocator.num_free < n:
            if self.index is None or self.index.evict_lru() is None:
                return None
        return self.allocator.alloc(n)

    def can_admit(self, prompt) -> bool:
        """Admission control: room for the prompt's *uncached* pages plus
        the first decode page (cached prefix pages are aliased, not
        allocated; the reclaimable count excludes them so this stays
        consistent with what :meth:`admit` can actually deliver)."""
        pages, _matched, n = self._lookup(prompt)
        need = self.pages_for(n + 1) - len(pages)
        if self.allocator.num_free >= need:
            return True  # free list suffices: skip the index walk
        extra = self.index.reclaimable_count(exclude=pages) if self.index else 0
        return self.allocator.num_free + extra >= need

    def fits(self, total_len: int) -> bool:
        """Whether a request of this total length can ever be served."""
        return (
            total_len <= self.max_len
            and self.pages_for(total_len) <= self.allocator.num_pages - 1
        )

    # -- slot lifecycle -----------------------------------------------------

    def admit(self, slot: int, prompt) -> Optional[int]:
        """Build a slot's table row for a prompt: alias the longest cached
        prefix (refcount + 1 per page), allocate the rest fresh.

        Returns the number of prompt tokens served from the prefix cache
        (0 without sharing), or None if the pool -- including LRU-evictable
        prefix pages -- is short."""
        assert slot not in self._pages, f"slot {slot} already occupied"
        cached, matched, n = self._lookup(prompt)
        if cached:
            # pin before allocating: the fresh-page eviction fallback must
            # not reclaim the very prefix this admission is aliasing
            self.allocator.ref(cached)
        got = self._alloc(self.pages_for(n + 1) - len(cached))
        if got is None:
            if cached:
                self.allocator.unref(cached)
            return None
        pages = cached + got
        self.pages_aliased += len(cached)
        self._pages[slot] = pages
        self._cached_tokens[slot] = matched
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        row[: len(pages)] = pages
        self._table[slot] = row
        self._table_dirty = True
        return matched

    def ensure_capacity(self, slot: int, next_pos: int) -> bool:
        """Grow the slot's mapping so position ``next_pos`` is writable,
        one page at a time, evicting cold prefix pages LRU before giving
        up.  Returns False on OOM -- the scheduler then preempts somebody."""
        pages = self._pages[slot]
        needed = next_pos // self.page_size + 1
        if needed > self.max_pages_per_seq:
            raise ValueError(
                f"slot {slot}: position {next_pos} exceeds max_len {self.max_len}"
            )
        while len(pages) < needed:
            got = self._alloc(1)
            if got is None:
                return False
            self._table[slot, len(pages)] = got[0]
            pages.extend(got)
            self._table_dirty = True
        return True

    def prepare_decode_write(self, slot: int, next_pos: int) -> bool:  # repro: hot-loop
        """Make position ``next_pos`` privately writable: copy-on-write.

        A decode write must not land in a page other requests (or the
        prefix index) still reference.  When the target page's refcount is
        > 1, allocate a fresh page, copy the page in place (the COW step),
        swap the slot's table entry, and drop the shared reference.  Returns
        False on OOM (the scheduler preempts, exactly like a growth
        failure).  ``ensure_capacity`` must already have mapped ``next_pos``.
        """
        lp = next_pos // self.page_size
        page = self._pages[slot][lp]
        if self.allocator.refcount(page) == 1:
            return True
        got = self._alloc(1)
        if got is None:
            return False
        new = got[0]
        self._cow(self.data, page, new)
        self._pages[slot][lp] = new
        self._table[slot, lp] = new
        self._table_dirty = True
        self.allocator.unref([page])
        self.cow_copies += 1
        return True

    def growth_deficit(self, slot: int, next_pos: int) -> int:
        """Pages the slot still needs to make ``next_pos`` privately
        writable (no allocation): missing table entries, plus one when the
        already-mapped target page is shared and will copy-on-write."""
        pages = self._pages[slot]
        lp = next_pos // self.page_size
        deficit = max(0, lp + 1 - len(pages))
        if deficit == 0 and self.allocator.refcount(pages[lp]) > 1:
            deficit = 1  # COW will allocate
        return deficit

    def release(self, slot: int) -> None:
        """Drop the slot's page references (finish or preemption); pages
        also pinned by the prefix index survive for future admissions."""
        pages = self._pages.pop(slot, None)
        if pages:
            self.allocator.unref(pages)
        self._cached_tokens.pop(slot, None)
        self._table[slot] = NULL_PAGE
        self._table_dirty = True

    def page_table(self) -> torch.Tensor:  # repro: hot-loop
        """Device mirror of the page tables (refreshed only when dirty).

        The mirror is one buffer for the pool's life, written in place by
        an asynchronous host->device copy (not a sync) only on steps where
        a table entry actually changed; steady-state decode reuses it
        without touching the host array."""
        if self._table_dirty:
            upload_into(self._table_dev, self._table)
            self._table_dirty = False
        return self._table_dev

    # -- prefill install ----------------------------------------------------

    def install_prefill(self, slot: int, prefill_caches) -> None:
        """Write one request's one-shot prefill caches into its slot, in place.

        ``prefill_caches`` is the (batch=1) tree from ``M.prefill``: paged
        segments scatter their K/V into the slot's physical pages.  The
        source may be right-padded past the slot's page allocation
        (bucketed prefill): those tokens map to the null page.  Idempotent
        per slot -- a re-admitted (preempted) request simply overwrites.
        """
        src_len = self._src_token_count(prefill_caches)
        phys_tok, off_tok = self.token_targets(slot, 0, src_len)
        self._install(self.data, prefill_caches, slot, phys_tok, off_tok)

    def install_partial(self, slot: int, src) -> None:
        """Install a partial source (only the segments and keys it carries)
        into a slot, in place -- the enc-dec admission's cross rows, written
        once before any prompt chunk runs.  Rows take no token targets."""
        self._install(self.data, src, slot, None, None)

    def _src_token_count(self, prefill_caches) -> int:
        """Token count of the (possibly padded) paged prefill source."""
        for si, (kind, _n) in enumerate(M.layer_segments(self.cfg)):
            seg = f"seg{si}"
            for ad in A.adapters_for(self.cfg, kind):
                if ad.paged and ad.key in prefill_caches.get(seg, {}):
                    return ad.src_tokens(prefill_caches[seg][ad.key])
        return 1  # no paged segment: targets unused

    # -- prefix cache --------------------------------------------------------

    def commit_prefix(self, slot: int, tokens: np.ndarray, n_tokens: int) -> None:
        """Publish the slot's completed full prefill pages (covering
        ``tokens[:n_tokens]``) into the prefix index.

        Called as prefill chunks complete, so a long prompt becomes
        shareable page by page -- and a request preempted mid-prefill leaves
        its finished pages cached, letting re-admission *resume* the suffix
        prefill.  Only full pages enter the index, and only tokens the host
        knows at prefill time; tokens still being decoded never do."""
        if self.index is None:
            return
        self.index.insert(tokens, self._pages[slot], n_tokens)

    # -- chunk write targets -------------------------------------------------

    def token_targets(  # repro: hot-loop
        self, slot: int, start: int, n: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`token_targets_host` as int32 device tensors."""
        phys, off = self.token_targets_host(slot, start, n)
        return to_device(phys, self.device), to_device(off, self.device)

    def token_targets_host(  # repro: hot-loop
        self, slot: int, start: int, n: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-token (physical page, in-page offset) for positions
        ``[start, start + n)`` of a slot, as int32 host arrays.  Positions
        past the slot's page allocation (the pad tail of a bucketed prompt)
        are routed to the null page, whose content is garbage by design --
        as are positions the slot serves from *aliased* prefix pages: their
        cache entries already exist and are shared, so a recompute's write
        must be dropped, not land in a page other requests read."""
        pages = np.asarray(  # repro: noqa RPR002 -- host list -> host array
            self._pages[slot], np.int64
        )
        pos = np.arange(start, start + n)
        lp = pos // self.page_size
        phys = np.where(
            (lp < len(pages)) & (pos >= self._cached_tokens.get(slot, 0)),
            pages[np.minimum(lp, len(pages) - 1)], NULL_PAGE,
        )
        return phys.astype(np.int32), (pos % self.page_size).astype(np.int32)

    def table_row(self, slot: int) -> torch.Tensor:
        """One slot's page-table row for the chunk-prefill gather -- a slice
        of the dirty-tracked device mirror."""
        return self.page_table()[slot]

    # -- stats --------------------------------------------------------------

    def cache_bytes(self) -> int:
        """Bytes of the whole pool, every rank's share counted once (the
        JAX package's: the global arrays' bytes)."""
        if self._specs is None:
            return self.cache_bytes_per_device()
        return SH.global_nbytes(self.data, self._specs, self.mesh)

    def cache_bytes_per_device(self) -> int:
        """The pool bytes this rank holds: head-sharded pools count 1/M,
        replicated pools (MLA latent pages, SSM rows, ring position labels)
        count whole.  Equals :meth:`cache_bytes` single-device."""
        return sum(t.numel() * t.element_size() for t in T.leaves(self.data))

    def slot_row_leaves(self) -> List[torch.Tensor]:
        """The pool leaves that hold one row per batch slot ((L, max_seqs,
        ...): SWA rings, SSM state and conv rows, enc-dec cross rows), every
        leaf of the non-paged adapters."""
        out = []
        for si, (kind, _n) in enumerate(M.layer_segments(self.cfg)):
            for ad in A.adapters_for(self.cfg, kind):
                if not ad.paged:
                    out.extend(self.data[f"seg{si}"][ad.key].values())
        return out

    def pool_ptrs(self) -> List[int]:
        """Device addresses of the pool tensors (they never move)."""
        return [t.data_ptr() for t in T.leaves(self.data)]

    # -- debug auditor -------------------------------------------------------

    def audit(self) -> "CacheAudit":
        """Cross-check the allocator's refcounts against the page holders.

        Every usable physical page must satisfy::

            refcount(page) == (#slots mapping it) + (1 if index-pinned)
            page in free list  <=>  refcount(page) == 0

        and the pool must balance: ``free + index_pinned + slot_held ==
        total`` (pages both index-pinned and slot-mapped count once, as
        index-pinned).  Raises ``AssertionError`` on any violation; returns
        the accounting breakdown.  Pure host bookkeeping — safe to run
        after every engine step (``EngineConfig.debug_audit``) or from
        tests as the shared refcount auditor.
        """
        alloc = self.allocator
        n = alloc.num_pages
        expected = [0] * n
        for slot, pages in self._pages.items():
            assert len(pages) <= self.max_pages_per_seq, (
                f"slot {slot} maps {len(pages)} pages > max_pages_per_seq "
                f"{self.max_pages_per_seq}"
            )
            for lp, p in enumerate(pages):
                assert NULL_PAGE < p < n, f"slot {slot} maps invalid page {p}"
                assert self._table[slot, lp] == p, (
                    f"slot {slot} local page {lp}: table says "
                    f"{self._table[slot, lp]}, _pages says {p}"
                )
                expected[p] += 1
        index_pages: set = set()
        if self.index is not None:
            for node in self.index._walk():
                p = node.page
                assert NULL_PAGE < p < n, f"prefix index pins invalid page {p}"
                assert p not in index_pages, (
                    f"prefix index pins page {p} from two nodes"
                )
                index_pages.add(p)
                expected[p] += 1
        free = set(alloc._free)
        assert len(free) == len(alloc._free), "free list contains duplicates"
        assert NULL_PAGE not in free and alloc._ref[NULL_PAGE] == 0, (
            "null page must stay unallocated and unreferenced"
        )
        for p in range(NULL_PAGE + 1, n):
            assert alloc._ref[p] == expected[p], (
                f"page {p}: refcount {alloc._ref[p]} != {expected[p]} "
                "(slot holders + index pin)"
            )
            assert (p in free) == (expected[p] == 0), (
                f"page {p}: refcount {expected[p]} inconsistent with "
                f"free-list membership ({p in free})"
            )
        slot_pages = {p for pages in self._pages.values() for p in pages}
        stats = CacheAudit(
            total=n - 1,
            free=len(free),
            index_pinned=len(index_pages),
            slot_held=len(slot_pages - index_pages),
        )
        assert stats.free + stats.index_pinned + stats.slot_held == stats.total, (
            f"page accounting does not balance: {stats}"
        )
        return stats


@dataclasses.dataclass(frozen=True)
class CacheAudit:
    """Page accounting snapshot from :meth:`PagedKVCache.audit`.

    ``total`` excludes the reserved null page; a page that is both
    index-pinned and slot-mapped counts under ``index_pinned``.
    """

    total: int
    free: int
    index_pinned: int
    slot_held: int
