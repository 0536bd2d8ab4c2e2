"""The meta-device counterpart of "lower and compile": one step, traced.

Counterpart of ``repro.analysis.aot``.  Where the JAX package lowers and
compiles a step to inspect it without running it, this port runs the step
once on ``meta`` tensors -- every operation computes shapes and dtypes and
no numbers -- and records what it would do on a device:

* **FLOPs** of the whole step, by :class:`torch.utils.flop_counter.
  FlopCounterMode`: the real per-device count of the matmuls and
  convolutions the program issues, backward included.  Unlike XLA's
  ``cost_analysis``, nothing is counted once per loop body: the port runs
  no scan, so a 61-layer model counts its 61 layers (the JAX roofline's
  ``useful_ratio`` compares the 6ND estimate with FLOPs that were ~L× low;
  here it compares with what the step really issues).
* **Collectives**: every collective of the port is an ``all_reduce`` or a
  ``broadcast`` of ``torch.distributed`` (:mod:`repro_torch.distributed.
  axes`), which a dispatch mode sees as ``c10d.allreduce_`` and
  ``c10d.broadcast_``; counted by kind with the bytes of their tensors,
  forward and backward.
* **Memory**: :func:`memory_record` gives the bytes of the arguments'
  storages, of the outputs' storages, and the peak of the storages alive
  during the step above the arguments (``temp_size_in_bytes``), each
  storage counted once however many views share it.
* **Gathers and conversions** (what ``repro_torch.analysis.torchcheck``
  reads where the JAX linter walks the jaxpr): the output and source bytes
  of every gather-family operation (:data:`GATHERS`), every dtype
  conversion with its from and to types (a copy to another dtype, an
  operand a pointwise operation promotes, an output wider than every
  tensor input), and the bytes of every storage the step allocated.

A process group for a production mesh needs no ranks: the ``fake`` backend
(:mod:`repro_torch.launch.dryrun`) accepts every collective and moves
nothing.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

#: The memory fields :func:`memory_record` gives, under the JAX package's
#: names.  The JAX record's ``alias_size_in_bytes`` (outputs donated into
#: arguments' buffers) and ``generated_code_size_in_bytes`` (the compiled
#: executable) have no counterpart in an eager step and are dropped; an
#: output written in place into an argument (a decode step's caches) is
#: counted in ``output_size_in_bytes`` as XLA counts an aliased output.
MEMORY_FIELDS = (
    "temp_size_in_bytes",
    "argument_size_in_bytes",
    "output_size_in_bytes",
)

#: The collectives a dispatch mode sees, by the name the dry run records.
COLLECTIVES = {"allreduce_": "all-reduce", "broadcast_": "broadcast"}

#: The gather-family operations (by overload packet) whose output bytes the
#: trace records: advanced indexing (``aten.index.Tensor``), ``gather``,
#: ``index_select``, ``embedding`` and ``take``.  Scatters (``index_put_``)
#: are not gathers, as XLA's ``scatter`` is not its ``gather``.
GATHERS = ("index", "gather", "index_select", "embedding", "take")


def _tensors(tree):
    """Every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _storage_bytes(tree) -> Dict[int, int]:
    """{storage id: bytes} of the tensors in ``tree``, each storage once."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def argument_bytes(args) -> int:
    """The ``argument_size_in_bytes`` of a step on ``args`` (a nest of
    tensors): their storages' bytes, each storage once."""
    return sum(_storage_bytes(args).values())


class _StepMode(TorchDispatchMode):
    """Watches every operation of a step: the live bytes of the storages it
    allocates (freed when the storage is), their peak, and the collectives
    with their bytes."""

    def __init__(self, known: Dict[int, int]):
        super().__init__()
        self.known = set(known)  # the arguments' storages
        self.live = 0
        self.peak = 0
        self.collectives: Dict[str, int] = {name: 0 for name in COLLECTIVES.values()}
        self.collectives["count"] = 0
        self.gathers: List[Dict[str, Any]] = []
        self.conversions: List[Dict[str, Any]] = []
        self.allocations: List[int] = []  # bytes of each storage allocated

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self.known.discard(key)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known:
                continue
            self.known.add(key)
            n = st.nbytes()
            self.allocations.append(n)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d" and func._opname in COLLECTIVES:
            kind = COLLECTIVES[func._opname]
            self.collectives[kind] += sum(t.numel() * t.element_size()
                                          for t in _tensors(args[0]))
            self.collectives["count"] += 1
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        self._track(out)
        return out

    def _convert(self, func, src, out: torch.Tensor) -> None:
        self.conversions.append({
            "op": str(func),
            "from": "none" if src is None else str(src).replace("torch.", ""),
            "to": str(out.dtype).replace("torch.", ""),
            "to_itemsize": out.element_size(),
            "output_bytes": out.numel() * out.element_size()})

    def _record(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if name in GATHERS and isinstance(out, torch.Tensor):
            src = args[0] if args and isinstance(args[0], torch.Tensor) else None
            self.gathers.append({
                "op": str(func), "output_bytes": out.numel() * out.element_size(),
                "source_bytes": 0 if src is None else src.numel() * src.element_size()})
        self._record_conversions(func, name, args, kwargs, out)

    def _record_conversions(self, func, name, args, kwargs, out) -> None:
        """The dtype conversions of one operation, explicit or implied --
        what the JAX jaxpr shows as ``convert_element_type``: a copy to
        another dtype (``_to_copy``, ``copy_``); an operand of a pointwise
        operation promoted to its output's dtype (``x * y`` with ``y``
        wider); and an output wider than every tensor input (a factory such
        as ``arange(..., dtype=float64)`` with none, ``sum`` of an int32
        tensor, ``argmax``)."""
        outs = list(_tensors(out))
        if not outs:
            return
        if name in ("_to_copy", "copy_", "copy"):
            src = args[1] if name != "_to_copy" else args[0]
            if isinstance(src, torch.Tensor) and src.dtype != outs[0].dtype:
                self._convert(func, src.dtype, outs[0])
            return
        ins = list(_tensors((args, kwargs)))
        widest_in = max(ins, key=lambda t: t.element_size(), default=None)
        pointwise = torch.Tag.pointwise in func.tags
        for o in outs:
            if widest_in is None or o.element_size() > widest_in.element_size():
                self._convert(func, None if widest_in is None else widest_in.dtype, o)
            elif pointwise:
                for dt in sorted({t.dtype for t in ins if t.dtype != o.dtype and
                                  t.dtype != torch.bool and
                                  t.element_size() < o.element_size()}, key=str):
                    self._convert(func, dt, o)


@dataclasses.dataclass
class TraceArtifact:
    """One step run on meta tensors: its FLOPs, collectives, memory and
    the seconds the trace took on the host."""

    flops: int
    collectives: Dict[str, int]
    memory: Dict[str, int]
    trace_s: float
    outputs: Any = dataclasses.field(default=None, repr=False)
    gathers: List[Dict[str, Any]] = dataclasses.field(default_factory=list, repr=False)
    conversions: List[Dict[str, Any]] = dataclasses.field(default_factory=list, repr=False)
    allocations: List[int] = dataclasses.field(default_factory=list, repr=False)


def trace_step(fn: Callable, args: Sequence, kwargs: Dict[str, Any] = None) -> TraceArtifact:
    """Run ``fn(*args, **kwargs)`` once under the FLOP counter and the
    storage and collective watch; never computes a number when ``args``
    are meta tensors (a step on real tensors is traced the same way and
    runs).  The outputs are kept on the artifact (``outputs``)."""
    kwargs = kwargs or {}
    arg_bytes = _storage_bytes((args, kwargs))
    watch = _StepMode(arg_bytes)
    counter = FlopCounterMode(display=False)
    t0 = time.time()
    with counter, watch:
        out = fn(*args, **kwargs)
    trace_s = time.time() - t0
    memory = {
        "temp_size_in_bytes": watch.peak,
        "argument_size_in_bytes": argument_bytes((args, kwargs)),
        "output_size_in_bytes": sum(_storage_bytes(out).values()),
    }
    return TraceArtifact(flops=int(counter.get_total_flops()),
                         collectives=dict(watch.collectives), memory=memory,
                         trace_s=trace_s, outputs=out, gathers=watch.gathers,
                         conversions=watch.conversions, allocations=watch.allocations)


def memory_record(artifact: TraceArtifact) -> Dict[str, int]:
    """The artifact's memory as a plain int dict in :data:`MEMORY_FIELDS`
    order."""
    return {k: int(artifact.memory[k]) for k in MEMORY_FIELDS}
