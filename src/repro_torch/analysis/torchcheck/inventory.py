"""The serving engine's hot-path step inventory, as step specs.

Counterpart of ``repro.analysis.jaxcheck.inventory``: a :class:`StepSpec`
per hot-path signature of the continuous engine -- the decode step, one
prefill chunk per shape in the engine's chunk-shape closure, the COW page
copy, and the unchunked prefill install -- under the JAX inventory's names,
from the callables the engine calls (:func:`repro_torch.serve.engine.
step_fns`).  The decode and COW specs run the kernel route (``"cuda"``) by
default and keep probe-less ``*_reference`` twins for the gather oracle;
see :attr:`InventoryConfig.backend`.

The JAX inventory compiles abstract shapes; the port's steps are eager, so
the arguments here are real tensors at the same smoke-sized geometry
(random weights from seed 0, zeroed pools and inputs) on the inventory's
device.  The kernel route exists only on the card: on the CPU the
``decode_step`` and ``cow_copy`` specs are left out (named in
:attr:`Inventory.left_out`), never run through the kernels' plain versions
under the kernel's name, and their probes move to the reference twins.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

import repro_torch.configs as C
from repro_torch.analysis.torchcheck.harness import ProbeSet, StepSpec
from repro_torch.core.encoder import resolve_device
from repro_torch.distributed import axes as AX
from repro_torch.models import model as M
from repro_torch.serve import engine as E

#: the steps that run the kernel route, and why the CPU leaves them out
KERNEL_STEPS = ("decode_step", "cow_copy")
LEFT_OUT_ON_CPU = ("the kernel route runs only on the card (on CPU tensors the "
                   "wrappers take their plain versions)")


@dataclasses.dataclass(frozen=True)
class InventoryConfig:
    """Geometry the inventory traces at (the JAX inventory's)."""

    arch: str = "minicpm-2b"
    max_seqs: int = 2
    max_len: int = 64
    page_size: int = 8
    #: prompt lengths the RPJ104 closure check plans chunks for — a short
    #: prompt (ragged bucket), an exact chunk, and a multi-chunk prompt
    probe_prompt_lens: Tuple[int, ...] = (3, 8, 13)
    #: decode/COW route the PRIMARY ``decode_step`` / ``cow_copy`` specs run
    #: (``cfg.decode_backend``): the CUDA kernels by default, the serving
    #: hot loop this analysis exists to budget.  Streaming pages through the
    #: kernel removes the whole-history ``k_pages[page_table]`` gather from
    #: the step, which is exactly the RPJ102 ``max_gather_bytes`` drop the
    #: paper's arrangement argument predicts.  The gather oracle stays gated
    #: as ``decode_step_reference`` / ``cow_copy_reference``.
    backend: str = "cuda"
    #: ``DxM`` mesh spec (e.g. ``"1x2"``): the SHARDED inventory, traced as
    #: rank 0 of a ``fake`` process group (made here when none is
    #: initialised; its collectives move nothing): the rank's shards of the
    #: weights, its share of the pools, every step under the serve layout's
    #: policy, so RPJ101 proves the in-place update survives sharding and
    #: RPJ106 budgets the step's collective traffic.  Empty = one device.
    mesh: str = ""
    #: where the steps run (default: the card; raises without one)
    device: Optional[str] = None
    #: the arch's smoke config (the JAX inventory's), or its full width
    smoke: bool = True


@dataclasses.dataclass
class Inventory:
    """Everything torchcheck analyzes: step specs + the RPJ104 closure."""

    cfg: Any
    geometry: InventoryConfig
    specs: List[StepSpec]
    chunk_size: int
    chunk_closure: Tuple[int, ...]
    chunk_plans: Dict[int, List[int]]  # probe prompt len -> planned shapes
    device: torch.device = None
    #: step -> why it was not traced
    left_out: Dict[str, str] = dataclasses.field(default_factory=dict)
    _made_group: bool = False

    def close(self) -> None:
        """Destroy the fake process group the mesh inventory made, if any."""
        if self._made_group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._made_group = False

    def __enter__(self) -> "Inventory":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def model_config(inv: InventoryConfig):
    cfg = C.get_config(inv.arch, smoke=inv.smoke, dtype=torch.float32)
    return dataclasses.replace(cfg, block=inv.page_size)


def _fake_group(world: int) -> bool:
    """Make rank 0 of a ``fake`` default group of ``world`` ranks (as the dry
    run does); True when made here.  A group of ranks already initialised
    is refused; a fake one of the right size is kept."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError("a process group is initialised; the mesh inventory "
                               f"traces rank 0 of a fake group of {world}")
        return False
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return True


def _under(policy, fn):
    """``fn`` run under the shard policy (None: as it is)."""
    if policy is None:
        return fn

    def run(*args):
        with AX.policy(policy):
            return fn(*args)

    return run


def serving_inventory(inv: Optional[InventoryConfig] = None) -> Inventory:
    inv = inv or InventoryConfig()
    cfg = model_config(inv)
    device = resolve_device(inv.device)
    # two step tables: the kernel route the budgets gate (inv.backend) and
    # the gather oracle it must keep matching.  Only decode/COW dispatch on
    # decode_backend; prefill chunks and install run the reference table.
    cfg_ref = dataclasses.replace(cfg, decode_backend="reference")
    cfg_hot = dataclasses.replace(cfg, decode_backend=inv.backend)
    steps = E.step_fns(cfg_ref)
    steps_hot = E.step_fns(cfg_hot)
    max_pages = max(1, -(-inv.max_len // inv.page_size))
    num_pages = inv.max_seqs * max_pages + 1
    B = inv.max_seqs

    made_group, policy, tp_size = False, None, 1
    full = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    if inv.mesh:
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch.mesh import make_serve_mesh, parse_mesh
        from repro_torch.serve.kvcache import check_serve_mesh

        made_group = _fake_group(math.prod(parse_mesh(inv.mesh)))
        mesh = make_serve_mesh(inv.mesh)
        tp_size = check_serve_mesh(mesh)
        SH.validate_paged_sharding(cfg, mesh)
        params, policy = E._rank_params(cfg, full, mesh, device)
        del full
    else:
        params = full

    # the parameters, which no step writes, are shared by every call
    # (probes included); each call gets a fresh pool, which it writes
    def fresh_caches():
        return M.init_paged_cache(cfg, B, num_pages, inv.page_size, inv.max_len,
                                  device=device, tp_size=tp_size)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    chunk_size = E.resolve_chunk_size(cfg, inv.page_size)
    closure = E.chunk_shape_set(cfg, chunk_size)
    plans = {n: E.chunk_plan(cfg, chunk_size, n) for n in inv.probe_prompt_lens}
    kernel_route_here = not (inv.backend == "cuda" and device.type != "cuda")
    left_out = {} if kernel_route_here else {name: LEFT_OUT_ON_CPU for name in KERNEL_STEPS}
    specs: List[StepSpec] = []

    def add(name, table, step, args, **kw):
        fn, in_place = table[step]
        specs.append(StepSpec(name=name, fn=_under(policy, fn), args=args,
                              donate_argnums=in_place, **kw))

    # -- decode step: one signature, forever -------------------------------
    def decode_args(_key=None):
        return (params, fresh_caches(), i32(B, 1), i32(B), i32(B, max_pages),
                torch.zeros((B,), dtype=torch.bool, device=device))

    decode_probe = ProbeSet(keys=(0, 1), make_args=decode_args, expected_entries=1)
    if kernel_route_here:
        add("decode_step", steps_hot, "decode_step", decode_args(), probe=decode_probe)
    add("decode_step_reference", steps, "decode_step", decode_args(),
        probe=None if kernel_route_here else decode_probe)

    # -- prefill chunk: one spec per shape in the closure -------------------
    def scalar(x):  # the chunk step's traced scalars: 0-dim int32 device tensors
        return torch.tensor(x, dtype=torch.int32, device=device)

    def chunk_args(n):
        return (params, fresh_caches(), i32(1, n), scalar(0), scalar(0), i32(n), i32(n),
                i32(max_pages), scalar(n - 1))

    for n in closure:
        add(f"prefill_chunk_{n}", steps, "prefill_chunk", chunk_args(n))

    # the probe drives the *planned* chunk sequence for every probe prompt;
    # its signatures must equal the distinct planned shapes
    planned = [n for plan in plans.values() for n in plan]
    full_spec = next(s for s in specs if s.name == f"prefill_chunk_{chunk_size}")
    full_spec.probe = ProbeSet(keys=tuple(planned), make_args=chunk_args,
                               expected_entries=len(set(planned)))
    full_spec.signature_plan = tuple(planned)
    full_spec.signature_closure = closure

    # -- COW page copy: page ids are host ints, one signature ---------------
    def cow_args(key=0):
        return (fresh_caches(), 1 + key, 2 + key)

    cow_probe = ProbeSet(keys=(0, 1), make_args=cow_args, expected_entries=1)
    if kernel_route_here:
        add("cow_copy", steps_hot, "cow_copy", cow_args(), probe=cow_probe)
    add("cow_copy_reference", steps, "cow_copy", cow_args(),
        probe=None if kernel_route_here else cow_probe)

    # -- unchunked install: one full-prefill source structure ---------------
    Sp = 2 * inv.page_size  # a bucketed two-page prompt
    with torch.no_grad(), AX.policy(policy):
        _, src = M.prefill(cfg, params, {"tokens": i32(1, Sp)}, Sp - 1)
    add("install", steps, "install", (fresh_caches(), src, 0, i32(Sp), i32(Sp)))

    return Inventory(cfg=cfg, geometry=inv, specs=specs, chunk_size=chunk_size,
                     chunk_closure=closure, chunk_plans=plans, device=device,
                     left_out=left_out, _made_group=made_group)
