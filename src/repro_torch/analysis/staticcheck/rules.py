"""Rule implementations for repro_torch.analysis.staticcheck.

Each rule is a callable ``(tree, ctx) -> List[Finding]`` registered in
``RULES``: the JAX package's rule of the same id, reading PyTorch's form of
the hazard.  Rules are intentionally heuristic: they operate on names and
call shapes, not types, and favour the idioms actually used in the port
(``adamw_update(..., donate=True)`` writing its tensors in place,
single-statement update-and-rebind, ``# repro: hot-loop`` engine methods).
Known blind spots are listed per rule.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from . import FilePragmas, Finding


@dataclasses.dataclass
class RuleContext:
    path: str
    source_lines: Sequence[str]
    pragmas: FilePragmas

    def snippet(self, line: int) -> str:
        if 0 < line <= len(self.source_lines):
            return self.source_lines[line - 1]
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=rule,
            path=self.path,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            snippet=self.snippet(line),
        )


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain of plain names, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _attach_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._rpr_parent = parent  # type: ignore[attr-defined]


def _parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_rpr_parent", None)


def _enclosing(node: ast.AST, kinds) -> Optional[ast.AST]:
    cur = _parent(node)
    while cur is not None and not isinstance(cur, kinds):
        cur = _parent(cur)
    return cur


def _flat_targets(targets: Sequence[ast.expr]) -> List[ast.expr]:
    out: List[ast.expr] = []
    stack = list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
        else:
            out.append(t)
    return out


def _method(node: ast.Call) -> Optional[str]:
    """The attribute name of a method call ``x.m(...)``, else None."""
    return node.func.attr if isinstance(node.func, ast.Attribute) else None


def _hot_functions(tree: ast.AST, ctx: RuleContext) -> List[ast.FunctionDef]:
    hot: List[ast.FunctionDef] = []
    if not ctx.pragmas.hot_lines:
        return hot
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        first = min([node.lineno] + [d.lineno for d in node.decorator_list])
        if ctx.pragmas.hot_lines & {node.lineno, first, first - 1}:
            hot.append(node)
    return hot


# ---------------------------------------------------------------------------
# RPR001 — use-after-donation
# ---------------------------------------------------------------------------
#
# The port's donation idiom: a call with the keyword ``donate=True`` writes
# the new values into the tensors it was given (``adamw_update`` copies the
# new parameters and moments into ``params`` and ``opt_state``), where the
# JAX package donates them to a jitted step.  A donated argument read again
# before rebinding sees the *updated* values where the code meant the old
# ones.  The donated arguments of the port's donating functions are listed
# in ``DONATED_ARGS`` (position, keyword); a ``donate=True`` call of any
# other callee donates every plain name or attribute it passes.
#
# A donated Name/Attribute argument is safe when the *same statement* rebinds
# it (``params, opt_state = adamw_update(..., opt_state, params, ...,
# donate=True)``); otherwise the first textually-later access in the
# enclosing function decides: Store => safe rebind, Load => finding.
# Blind spots: donation through intermediate locals, cross-function flows,
# loop-carried reads before the loop's rebind, and ``donate=<variable>``.

#: callee name -> ((position, keyword), ...) of the arguments it writes in
#: place when called with ``donate=True``
DONATED_ARGS: Dict[str, Tuple[Tuple[int, str], ...]] = {
    "adamw_update": ((1, "opt_state"), (2, "params")),
}


def _donates(call: ast.Call) -> bool:
    return any(
        kw.arg == "donate"
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is True
        for kw in call.keywords
    )


def _donated_args(call: ast.Call) -> List[Tuple[str, ast.expr]]:
    """(label, argument expression) of each argument a donating call
    writes in place."""
    name = _dotted(call.func) or ""
    known = DONATED_ARGS.get(name.rsplit(".", 1)[-1])
    if known is None:
        out = [(f"position {i}", a) for i, a in enumerate(call.args)]
        out += [(f"keyword {kw.arg}", kw.value) for kw in call.keywords
                if kw.arg not in (None, "donate")]
        return out
    out = []
    for pos, kw_name in known:
        if pos < len(call.args):
            out.append((f"position {pos}", call.args[pos]))
        for kw in call.keywords:
            if kw.arg == kw_name:
                out.append((f"keyword {kw_name}", kw.value))
    return out


def rule_rpr001(tree: ast.AST, ctx: RuleContext) -> List[Finding]:
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and _donates(n)]
    if calls:
        _attach_parents(tree)
    findings: List[Finding] = []
    for call in calls:
        desc = _dotted(call.func) or "<call>"
        for label, arg in _donated_args(call):
            findings.extend(_check_donated_arg(call, arg, label, desc, ctx))
    return findings


def _check_donated_arg(
    call: ast.Call, arg: ast.expr, label: str, desc: str, ctx: RuleContext
) -> List[Finding]:
    key = _dotted(arg)
    if key is None:  # fresh temporary (e.g. T.unflatten(...)): nothing to track
        return []
    stmt = _enclosing(call, ast.stmt)
    if stmt is None:
        return []
    # Same-statement rebind: `params, opt_state = adamw_update(..., donate=True)`
    if isinstance(stmt, ast.Assign):
        if any(_dotted(t) == key for t in _flat_targets(stmt.targets)):
            return []
    scope = _enclosing(call, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module))
    if scope is None:
        return []
    stmt_end = getattr(stmt, "end_lineno", stmt.lineno)
    accesses = []
    for node in ast.walk(scope):
        if not isinstance(node, (ast.Name, ast.Attribute)):
            continue
        if node.lineno <= stmt_end or _dotted(node) != key:
            continue
        accesses.append(node)
    accesses.sort(key=lambda n: (n.lineno, n.col_offset))
    for node in accesses:
        is_store = isinstance(node.ctx, (ast.Store, ast.Del)) and not isinstance(
            _parent(node), ast.AugAssign
        )
        if is_store:
            return []  # rebound before any read
        return [
            ctx.finding(
                "RPR001",
                node,
                f"'{key}' is donated to '{desc}' at line {call.lineno} "
                f"({label}, donate=True writes it in place) and is read here "
                "before rebinding",
            )
        ]
    return []


# ---------------------------------------------------------------------------
# RPR002 — host sync in a `# repro: hot-loop` function
# ---------------------------------------------------------------------------
#
# The JAX rule's forms, plus the operations whose output shape depends on
# the data: on CUDA each waits for the device to learn its size.

_SYNC_CALLS = {
    "np.asarray", "np.stack", "numpy.asarray", "numpy.stack",
    "torch.nonzero", "torch.unique", "torch.masked_select",
}
_SYNC_METHODS = {"item", "tolist", "__array__", "nonzero", "unique", "masked_select"}
_SYNC_BUILTINS = {"float", "int", "bool"}


def rule_rpr002(tree: ast.AST, ctx: RuleContext) -> List[Finding]:
    findings: List[Finding] = []
    for fn in _hot_functions(tree, ctx):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted in _SYNC_CALLS:
                findings.append(
                    ctx.finding(
                        "RPR002",
                        node,
                        f"`{dotted}` in hot-loop `{fn.name}` forces a "
                        "device->host sync; defer or pragma the sanctioned "
                        "sync point",
                    )
                )
            elif _method(node) in _SYNC_METHODS:
                findings.append(
                    ctx.finding(
                        "RPR002",
                        node,
                        f"`.{node.func.attr}()` in hot-loop `{fn.name}` "
                        "forces a device->host sync",
                    )
                )
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in _SYNC_BUILTINS
                and node.args
                and not all(isinstance(a, ast.Constant) for a in node.args)
            ):
                findings.append(
                    ctx.finding(
                        "RPR002",
                        node,
                        f"`{node.func.id}(...)` in hot-loop `{fn.name}` "
                        "blocks on the device value; defer or pragma if this "
                        "sync is sanctioned",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# RPR003 — a compile or graph capture constructed inside a loop
# ---------------------------------------------------------------------------

_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_COMPS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_COMPILE_CALLS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.CUDAGraph", "torch.cuda.graph",
}


def rule_rpr003(tree: ast.AST, ctx: RuleContext) -> List[Finding]:
    calls = [n for n in ast.walk(tree)
             if isinstance(n, ast.Call) and _dotted(n.func) in _COMPILE_CALLS]
    if calls:
        _attach_parents(tree)
    findings: List[Finding] = []
    for node in calls:
        cur = _parent(node)
        container = None
        while cur is not None:
            if isinstance(cur, _LOOPS + _COMPS):
                container = cur
                break
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                # a def inside a loop compiles per iteration only when
                # called; RPR003 targets direct construction in the loop body
                break
            cur = _parent(cur)
        if container is not None:
            kind = "comprehension" if isinstance(container, _COMPS) else "loop"
            findings.append(
                ctx.finding(
                    "RPR003",
                    node,
                    f"`{_dotted(node.func)}` constructed inside a {kind} (line "
                    f"{container.lineno}): each iteration compiles or captures "
                    "anew; hoist it or memoize the compiled callable",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# RPR004 — family branch outside the adapter registry
# ---------------------------------------------------------------------------

FAMILY_LITERALS = {
    "dense",
    "moe",
    "ssm",
    "hybrid",
    "encdec",
    "vlm",
    "mla",
    "swa",
    "full",
}
_SUBJECT_HINTS = {"family", "fam", "attn_type", "kind"}
_REGISTRY_SUFFIX = ("src", "repro_torch", "models", "adapters.py")


def _is_registry_file(path: str) -> bool:
    parts = Path(path).parts
    return parts[-len(_REGISTRY_SUFFIX):] == _REGISTRY_SUFFIX or parts[-3:] == (
        "repro_torch",
        "models",
        "adapters.py",
    )


def _family_strings(node: ast.expr) -> Set[str]:
    vals: Set[str] = set()
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        vals.add(node.value)
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                vals.add(e.value)
    return vals & FAMILY_LITERALS


def rule_rpr004(tree: ast.AST, ctx: RuleContext) -> List[Finding]:
    if _is_registry_file(ctx.path):
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        lits: Set[str] = set()
        for side in [node.left] + list(node.comparators):
            lits |= _family_strings(side)
        if not lits:
            continue
        subjects = {
            n.id for n in ast.walk(node) if isinstance(n, ast.Name)
        } | {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}
        if not (subjects & _SUBJECT_HINTS):
            continue
        findings.append(
            ctx.finding(
                "RPR004",
                node,
                f"branch on layer-family literal(s) {sorted(lits)} outside "
                "the adapter registry (src/repro_torch/models/adapters.py); "
                "add a capability flag or adapter hook instead",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# RPR005 — stray print / breakpoint / pdb.set_trace in src/
# ---------------------------------------------------------------------------

_DEBUG_CALLS = {
    "print": "print()",
    "breakpoint": "breakpoint()",
    "pdb.set_trace": "pdb.set_trace()",
}


def rule_rpr005(tree: ast.AST, ctx: RuleContext) -> List[Finding]:
    if "src" not in Path(ctx.path).parts:
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted in _DEBUG_CALLS:
            findings.append(
                ctx.finding(
                    "RPR005",
                    node,
                    f"stray `{_DEBUG_CALLS[dotted]}` in src/; use logging or "
                    "pragma CLI entry points",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# RPR006 — explicit device->host transfer in a `# repro: hot-loop` function
# ---------------------------------------------------------------------------
#
# RPR002 catches the *accidental* syncs (`.item()`, `int(t)`); this rule
# catches the spelled-out ones: `t.cpu()`, `t.numpy()`, `t.to("cpu")` pull a
# device value to the host, `torch.cuda.synchronize()` and a stream's or
# event's `.synchronize()` block until the device drains, and `np.array(t)`
# copies; each serializes the launch pipeline when it sits inside a
# hot-loop function.  A `.numpy()` of a `.cpu()` is one transfer, reported
# once.  Sanctioned sync points carry a `# repro: noqa RPR006` pragma with
# the justification, same as RPR002.

_TRANSFER_CALLS = {"np.array", "numpy.array"}
_TRANSFER_METHODS = {"cpu", "numpy", "synchronize"}


def _is_host_literal(node: ast.AST) -> bool:
    """A value built purely from literals — no device tensor involved."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        return all(_is_host_literal(e) for e in node.elts)
    if isinstance(node, ast.Dict):
        return all(
            k is not None and _is_host_literal(k) and _is_host_literal(v)
            for k, v in zip(node.keys, node.values)
        )
    return False


def _names_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (
        isinstance(node, ast.Call)
        and _dotted(node.func) == "torch.device"
        and bool(node.args)
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "cpu"
    )


def _is_to_cpu(node: ast.Call) -> bool:
    if _method(node) != "to":
        return False
    if node.args and _names_cpu(node.args[0]):
        return True
    return any(kw.arg == "device" and _names_cpu(kw.value) for kw in node.keywords)


def _is_transfer(node: ast.Call) -> bool:
    return _method(node) in ("cpu", "synchronize") or _is_to_cpu(node)


def rule_rpr006(tree: ast.AST, ctx: RuleContext) -> List[Finding]:
    findings: List[Finding] = []
    for fn in _hot_functions(tree, ctx):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted in _TRANSFER_CALLS:
                # np.array(LITERAL) builds a host constant — no device involved
                if node.args and all(_is_host_literal(a) for a in node.args):
                    continue
                findings.append(
                    ctx.finding(
                        "RPR006",
                        node,
                        f"`{dotted}(...)` in hot-loop `{fn.name}` transfers "
                        "a device value to host; defer the fetch or pragma "
                        "the sanctioned sync point",
                    )
                )
                continue
            method = _method(node)
            if method == "numpy":
                recv = node.func.value
                if isinstance(recv, ast.Call) and _is_transfer(recv):
                    continue  # `.cpu().numpy()`: the `.cpu()` is reported
            if method in _TRANSFER_METHODS or _is_to_cpu(node):
                what = "to(\"cpu\")" if _is_to_cpu(node) else f"{method}()"
                findings.append(
                    ctx.finding(
                        "RPR006",
                        node,
                        f"`.{what}` in hot-loop `{fn.name}` blocks the "
                        "launch pipeline on device completion",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# RPR007 — hard-coded device selection in the serving stack
# ---------------------------------------------------------------------------
#
# The engine places its pools and weights on the device it was given (a
# mesh rank on its own card, `resolve_device`); code under `src/.../serve`
# that names a device index (`"cuda:0"`, `torch.device("cuda", 1)`,
# `torch.cuda.set_device(0)`) or moves a tensor with `.cuda()` (the
# *current* device, not the engine's) pins work to one card and silently
# breaks the mesh path: every rank's buffers land on card 0.
# `x.to(self.device)` and `.cuda(device)` with a variable are not flagged.

_CUDA_INDEX = re.compile(r"^cuda:\d+$")


def _in_serve_tree(path: str) -> bool:
    parts = Path(path).parts
    return "src" in parts and "serve" in parts


def _int_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and type(node.value) is int


def rule_rpr007(tree: ast.AST, ctx: RuleContext) -> List[Finding]:
    if not _in_serve_tree(ctx.path):
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and _CUDA_INDEX.match(node.value)
        ):
            findings.append(
                ctx.finding(
                    "RPR007",
                    node,
                    f"device literal {node.value!r} hard-codes a card in the "
                    "serving stack; place on the engine's device",
                )
            )
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if (
            dotted == "torch.device"
            and len(node.args) >= 2
            and _int_literal(node.args[1])
        ):
            findings.append(
                ctx.finding(
                    "RPR007",
                    node,
                    "`torch.device(..., <int>)` hard-codes a card in the "
                    "serving stack; place on the engine's device",
                )
            )
        elif dotted == "torch.cuda.set_device" and node.args and isinstance(
            node.args[0], ast.Constant
        ):
            findings.append(
                ctx.finding(
                    "RPR007",
                    node,
                    "`torch.cuda.set_device(<literal>)` pins the serving "
                    "stack to one card; a mesh rank selects its own",
                )
            )
        elif _method(node) == "cuda" and dotted != "torch.cuda" and (
            not node.args and not node.keywords
            or (node.args and _int_literal(node.args[0]))
        ):
            findings.append(
                ctx.finding(
                    "RPR007",
                    node,
                    "`.cuda()` moves to the current card, not the engine's "
                    "device; use `.to(device)`",
                )
            )
    return findings


RULES: Dict[str, Callable[[ast.AST, RuleContext], List[Finding]]] = {
    "RPR001": rule_rpr001,
    "RPR002": rule_rpr002,
    "RPR003": rule_rpr003,
    "RPR004": rule_rpr004,
    "RPR005": rule_rpr005,
    "RPR006": rule_rpr006,
    "RPR007": rule_rpr007,
}
