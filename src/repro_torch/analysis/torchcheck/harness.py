"""Trace harness: turn step specs into inspectable traced artifacts.

Counterpart of ``repro.analysis.jaxcheck.harness``.  A :class:`StepSpec`
names one hot-path step of the engine (the callable, real example
arguments, the positions of the arguments it writes in place, plus the
optional RPJ104 signature-probe declaration); :func:`trace` runs it once
through :func:`repro_torch.analysis.aot.trace_step` -- the dry run's
storage and dispatch watch, not a second tracer -- and extracts the facts
the rules consume:

* every gather-family operation's output bytes and every dtype conversion,
* the storages of the in-place arguments and of the outputs, and the bytes
  of each storage the step allocated,
* the memory record (temp / argument / output bytes, and the in-place
  bytes under the JAX record's name ``alias_size_in_bytes``), on the card
  also ``torch.cuda.max_memory_allocated()`` above the arguments,
* the collectives (``all_reduce``, ``broadcast``) and their bytes,
* the kernels the step launched (the wrappers' counters).

The steps run for real: the kernel route exists only on the card, where
the kernels' wrappers launch them; on the CPU the wrappers would take
their plain versions, so the inventory leaves those steps out.  Also
here: :func:`signature` (what RPJ104 counts) and :func:`sync_guard`, the
counterpart of ``jax.transfer_guard("disallow")`` around an engine step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels as K
from repro_torch.analysis import aot


@dataclasses.dataclass
class ProbeSet:
    """RPJ104 signature probes: real-argument factories whose calls must
    present exactly ``expected_entries`` distinct input signatures.

    ``keys`` may intentionally repeat a signature (two calls that must
    share one capture); ``make_args(key)`` must return *fresh* pools every
    call -- the steps write them in place."""

    keys: Sequence[Any]
    make_args: Callable[[Any], tuple]
    expected_entries: int


@dataclasses.dataclass
class StepSpec:
    """One hot-path step of the engine, declared for analysis."""

    name: str
    fn: Callable
    args: tuple  # nests of real tensors (and Python scalars)
    #: positions of the arguments the step writes in place and returns (the
    #: JAX package's ``donate_argnums``)
    donate_argnums: Tuple[int, ...] = ()
    probe: Optional[ProbeSet] = None
    #: RPJ104 static closure: the chunk shapes admission is planned to run,
    #: and the closed set they must stay inside
    signature_plan: Optional[Sequence[Any]] = None
    signature_closure: Optional[Sequence[Any]] = None


@dataclasses.dataclass
class TracedStep:
    """A step spec plus everything the rules read off its run."""

    spec: StepSpec
    artifact: aot.TraceArtifact
    gathers: List[Dict[str, Any]]
    conversions: List[Dict[str, Any]]
    donated: Dict[int, Tuple[str, int]]  # storage id -> (label, bytes)
    returned: FrozenSet[int]  # storage ids among the outputs
    allocations: List[int]
    memory: Dict[str, int]
    collectives: Dict[str, int]
    launches: Dict[str, int]

    @property
    def name(self) -> str:
        return self.spec.name


# ---------------------------------------------------------------------------
# Argument nests
# ---------------------------------------------------------------------------


def leaves_with_path(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(label, leaf) of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_path(v, f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]


def signature(args) -> tuple:
    """The input signature of a call: the shape, dtype and device of each
    tensor leaf and the type of each other leaf -- what one CUDA-graph
    capture is specialised to (a Python int's value aside)."""
    sig = []
    for label, leaf in leaves_with_path(args):
        if isinstance(leaf, torch.Tensor):
            sig.append((label, tuple(leaf.shape), str(leaf.dtype), str(leaf.device)))
        else:
            sig.append((label, type(leaf).__name__))
    return tuple(sig)


def _storages(tree) -> Dict[int, int]:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for _, t in leaves_with_path(tree) if isinstance(t, torch.Tensor)}


def donated_storages(args: Sequence, donate_argnums) -> Dict[int, Tuple[str, int]]:
    """Storage id -> (label, bytes) of every tensor of the in-place
    arguments."""
    out = {}
    for i in donate_argnums:
        for label, leaf in leaves_with_path(args[i], f"arg{i}"):
            if isinstance(leaf, torch.Tensor):
                st = leaf.untyped_storage()
                out.setdefault(st._cdata, (label, st.nbytes()))
    return out


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


def _device_of(args) -> Optional[torch.device]:
    for _, leaf in leaves_with_path(args):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def trace(spec: StepSpec) -> TracedStep:
    """Run one step spec once under the watch and extract the rule-facing
    facts."""
    donated = donated_storages(spec.args, spec.donate_argnums)
    device = _device_of(spec.args)
    on_card = device is not None and device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = K.launch_counts()
    art = aot.trace_step(spec.fn, spec.args)
    after = K.launch_counts()
    memory = aot.memory_record(art)
    returned = frozenset(_storages(art.outputs))
    memory["alias_size_in_bytes"] = sum(n for key, (_, n) in donated.items()
                                        if key in returned)
    if on_card:
        torch.cuda.synchronize(device)
        memory["device_peak_above_args"] = torch.cuda.max_memory_allocated(device) - base
    collectives = dict(art.collectives)
    art.outputs = None  # the rules read storage ids, not the tensors
    return TracedStep(
        spec=spec, artifact=art, gathers=art.gathers, conversions=art.conversions,
        donated=donated, returned=returned, allocations=art.allocations,
        memory=memory, collectives=collectives,
        launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
    )


def collective_bytes(ts: TracedStep) -> int:
    return sum(v for k, v in ts.collectives.items() if k != "count")


def measure(ts: TracedStep) -> Dict[str, int]:
    """The numbers ``--write-budgets`` checks in for one traced step."""
    record = {k: v for k, v in ts.memory.items() if k != "device_peak_above_args"}
    record["max_gather_bytes"] = max((g["output_bytes"] for g in ts.gathers), default=0)
    record["collective_bytes"] = collective_bytes(ts)
    return record


# ---------------------------------------------------------------------------
# The sync guard: the counterpart of jax.transfer_guard("disallow")
# ---------------------------------------------------------------------------

#: the operations that read a device value on the host (``.item()``,
#: ``int(t)``, ``bool(t)``) or size an output by the data
SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "_unique2",
            "unique_dim", "unique_consecutive")
#: indexing operations that sync on the card when an index is a boolean mask
MASK_INDEX_OPS = ("index", "index_put", "index_put_")


def _bool_index(args) -> bool:
    return len(args) > 1 and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                 for i in args[1] or ())


class _SyncGuardMode(TorchDispatchMode):
    """Raises on every operation of :data:`SYNC_OPS`, and on indexing by a
    boolean mask (the CPU's guard: a CPU tensor never syncs, so the
    operations that would on the card are named).  ``.tolist()`` and
    ``.numpy()`` of a CPU tensor reach no operator: staticcheck's RPR002
    and RPR006 find them in the source, the card's guard at run time."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in SYNC_OPS or (name in MASK_INDEX_OPS and _bool_index(args)):
            raise RuntimeError(f"sync guard: {func} inside a guarded step "
                               "(a device->host sync on the card)")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def sync_guard(device):
    """Forbid host syncs for the scope: on the card
    ``torch.cuda.set_sync_debug_mode("error")`` (reset on exit), on the CPU
    a dispatch mode that raises on the operations that sync on the card."""
    device = torch.device(device)
    if device.type == "cuda":
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    else:
        with _SyncGuardMode():
            yield


def guarded(fn: Callable, device, calls: Optional[List[int]] = None) -> Callable:
    """``fn`` run under :func:`sync_guard`.  Python evaluates the arguments
    before the wrapper's body, so the call site's staging (the uploads of
    positions and page tables) stays outside the guard, as in the JAX
    package.  ``calls``: a one-element list counting the guarded calls."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with sync_guard(device):
            out = fn(*args, **kwargs)
        if calls is not None:
            calls[0] += 1
        return out

    return wrapped
