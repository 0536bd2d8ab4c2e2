"""RPJ101–RPJ106: the step rules.

Counterpart of ``repro.analysis.jaxcheck.rules``: each rule is
``rule(steps, inv, budgets) -> List[Finding]`` over the traced inventory
(:class:`harness.TracedStep`); waivers from the budgets file suppress a
rule per step (or globally).  All rules read the traced runs except the
RPJ104 probes, which drive real smoke-sized calls and count their input
signatures.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.analysis.torchcheck import (
    GATED_MEMORY_FIELDS,
    ITEMSIZE,
    RULE_IDS,
    Budgets,
    Finding,
)
from repro_torch.analysis.torchcheck.harness import TracedStep, collective_bytes, signature


def rule_rpj101(steps, inv, budgets) -> List[Finding]:
    """In place: every storage of every in-place (JAX: donated) argument
    must come back among the step's outputs' storages, and the step may
    allocate no storage the size of the smallest such leaf -- a pool leaf
    that is returned as a new storage, or copied whole, means the in-place
    update the engine depends on silently became a copy."""
    out = []
    for ts in steps:
        if not ts.donated:
            continue
        missing = sorted(label for key, (label, _) in ts.donated.items()
                         if key not in ts.returned)
        if missing:
            labels = ", ".join(missing[:4])
            if len(missing) > 4:
                labels += f", ... ({len(missing) - 4} more)"
            out.append(Finding(
                "RPJ101", ts.name,
                f"in-place argument storage(s) not among the outputs "
                f"(the update became a copy): {labels}",
            ))
        smallest = min(n for _, n in ts.donated.values())
        big = [n for n in ts.allocations if n >= smallest]
        if big:
            out.append(Finding(
                "RPJ101", ts.name,
                f"{len(big)} allocation(s) of a pool leaf's size (largest {max(big)} B, "
                f"smallest pool leaf {smallest} B): a copy of the pool",
            ))
    return out


def rule_rpj102(steps, inv, budgets) -> List[Finding]:
    """Materialized-gather: the largest gather-family output of a step must
    stay under the step's ``max_gather_bytes`` budget -- the 'whole K/V
    pool gathered into a dense buffer' hazard."""
    out = []
    for ts in steps:
        if not ts.gathers:
            continue
        biggest = max(g["output_bytes"] for g in ts.gathers)
        budget = budgets.budget(ts.name, "max_gather_bytes")
        if budget is None:
            out.append(Finding(
                "RPJ102", ts.name,
                f"{len(ts.gathers)} gather op(s) (largest output {biggest} B) "
                f"but no max_gather_bytes budget — run --write-budgets",
            ))
        elif not budgets.allowed(ts.name, "max_gather_bytes", biggest):
            out.append(Finding(
                "RPJ102", ts.name,
                f"gather output {biggest} B exceeds budget {budget} B "
                f"(+{budgets.tolerance:.0%} tolerance)",
            ))
    return out


def rule_rpj103(steps, inv, budgets) -> List[Finding]:
    """Dtype-promotion drift: no conversion in a hot step may widen past
    the planned widest dtype (``allowed_widest``) — a stray float64/int64
    promotion doubles the bytes every downstream op moves.  A pair the
    budgets name in ``allow_conversion`` passes; every other pair is still
    reported."""
    widest = ITEMSIZE[budgets.allowed_widest]
    out = []
    for ts in steps:
        seen = set()
        for c in ts.conversions:
            if c["to_itemsize"] <= widest:
                continue
            pair = (c["from"], c["to"])
            if pair in seen or budgets.conversion_allowed(ts.name, pair):
                continue
            seen.add(pair)
            out.append(Finding(
                "RPJ103", ts.name,
                f"upcast {c['from']} -> {c['to']} ({c['op']}) is wider than "
                f"allowed_widest={budgets.allowed_widest}",
            ))
    return out


def rule_rpj104(steps, inv, budgets) -> List[Finding]:
    """Retrace-closure: (a) statically, every chunk shape admission plans
    must lie inside the enumerated closure; (b) live, each step's probe
    calls must present exactly the declared number of distinct input
    signatures — more means a shape/dtype/type leak that would need a CUDA
    graph (or a compiled callable) per call at serve time."""
    out = []
    for ts in steps:
        spec = ts.spec
        if spec.signature_plan is not None and spec.signature_closure is not None:
            escaped = sorted(set(spec.signature_plan) - set(spec.signature_closure))
            if escaped:
                out.append(Finding(
                    "RPJ104", ts.name,
                    f"planned chunk shape(s) {escaped} escape the "
                    f"enumerated closure {tuple(spec.signature_closure)}",
                ))
        if spec.probe is None:
            continue
        seen = set()
        for key in spec.probe.keys:
            args = spec.probe.make_args(key)
            seen.add(signature(args))
            spec.fn(*args)
        if len(seen) != spec.probe.expected_entries:
            out.append(Finding(
                "RPJ104", ts.name,
                f"{len(spec.probe.keys)} probe call(s) presented {len(seen)} "
                f"input signatures, expected {spec.probe.expected_entries} "
                f"(signature leak)",
            ))
    return out


def rule_rpj105(steps, inv, budgets) -> List[Finding]:
    """Memory-budget regression: the traced temp / argument / output bytes
    must stay within the checked-in budget (plus tolerance); a step with no
    budget at all must be baselined first."""
    out = []
    for ts in steps:
        for field in GATED_MEMORY_FIELDS:
            value = ts.memory.get(field)
            if value is None:
                continue
            budget = budgets.budget(ts.name, field)
            if budget is None:
                out.append(Finding(
                    "RPJ105", ts.name,
                    f"no budget for {field} (measured {value} B) — "
                    f"run --write-budgets",
                ))
            elif not budgets.allowed(ts.name, field, value):
                out.append(Finding(
                    "RPJ105", ts.name,
                    f"{field} {value} B exceeds budget {budget} B "
                    f"(+{budgets.tolerance:.0%} tolerance)",
                ))
    return out


def rule_rpj106(steps, inv, budgets) -> List[Finding]:
    """Collective-traffic budget: the ``all_reduce`` and ``broadcast``
    bytes a sharded step sends (the dispatch watch's count) must stay under
    the step's ``collective_bytes`` budget.  The hazard this pins down: a
    sharding change that gathers the head-sharded KV pool (or the weights)
    every decode step.  Steps with no collectives (one device) pass without
    a budget."""
    out = []
    for ts in steps:
        n = ts.collectives.get("count", 0)
        if not n:
            continue
        total = collective_bytes(ts)
        kinds = ", ".join(f"{k} {v} B" for k, v in sorted(ts.collectives.items())
                          if k != "count" and v)
        budget = budgets.budget(ts.name, "collective_bytes")
        if budget is None:
            out.append(Finding(
                "RPJ106", ts.name,
                f"{n} collective(s) ({kinds}) moving {total} B "
                f"but no collective_bytes budget — run --write-budgets",
            ))
        elif not budgets.allowed(ts.name, "collective_bytes", total):
            out.append(Finding(
                "RPJ106", ts.name,
                f"collective traffic {total} B ({kinds}) exceeds budget "
                f"{budget} B (+{budgets.tolerance:.0%} tolerance)",
            ))
    return out


RULES: Dict[str, Callable] = {
    "RPJ101": rule_rpj101,
    "RPJ102": rule_rpj102,
    "RPJ103": rule_rpj103,
    "RPJ104": rule_rpj104,
    "RPJ105": rule_rpj105,
    "RPJ106": rule_rpj106,
}
assert tuple(RULES) == RULE_IDS


def run_rules(
    steps: Sequence[TracedStep],
    inv,
    budgets: Budgets,
    select: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """All (selected) rules over the traced inventory, waivers applied."""
    selected = tuple(select) if select else RULE_IDS
    findings: List[Finding] = []
    for rule_id in selected:
        for f in RULES[rule_id](steps, inv, budgets):
            if not budgets.waived(f.rule, f.step):
                findings.append(f)
    return findings
