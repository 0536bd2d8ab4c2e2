"""repro_torch.analysis.torchcheck -- static analysis over the engine's steps.

Counterpart of ``repro.analysis.jaxcheck`` (the name changes: the port has
no JAX).  :mod:`repro_torch.analysis.staticcheck` lints Python source; the
hazards that matter for the serving hot path live one level down, in what
a step does on the device: an in-place pool update can silently become a
copy, a paged-decode gather can materialize the whole K/V history, an
upcast can creep into a hot step, a code change can leak new input
signatures (each a new CUDA-graph capture), and the step's memory can
regress.  The JAX linter compiles its jitted steps ahead of time; the
port's steps are eager, so this package runs each step of the engine's
inventory (:func:`repro_torch.serve.engine.step_fns`) once under the
storage and dispatch watch of :func:`repro_torch.analysis.aot.trace_step`
and proves the same claims, rule for rule:

===========  ==================================================================
rule id      what it catches
===========  ==================================================================
``RPJ101``   in place: a storage of the pool argument (which the JAX step
             donates) that does not come back among the outputs' storages,
             or an allocation the size of a pool leaf -- the update became
             a copy
``RPJ102``   materialized gather: a gather-family operation (``index``,
             ``gather``, ``index_select``, ``embedding``, ``take``) whose
             output bytes exceed the step's budget -- the "full K/V
             gathered" hazard the paged kernels exist to avoid
``RPJ103``   dtype-promotion drift: a conversion (``_to_copy``, ``copy_``,
             an operand promoted by a pointwise operation, an output wider
             than every input) to a type wider than the planned widest
             dtype inside a hot step, unless its pair is allowed
``RPJ104``   retrace closure: a chunk shape escaping the enumerated closure,
             or probe calls presenting more input signatures (the shape,
             dtype and device of each tensor, the type of each other value)
             than declared -- each one a CUDA-graph capture of its own
``RPJ105``   memory-budget regression: the traced temp / argument / output
             bytes over the checked-in budget
``RPJ106``   collective-traffic budget: the ``all_reduce`` and ``broadcast``
             bytes a step on a mesh sends, over its budget
===========  ==================================================================

Budgets and waivers live in the checked-in ``torchcheck.budgets`` (and
``torchcheck_mesh.budgets`` for ``--mesh``), in the JAX package's format:
``waive = RPJ102 -- reason`` suppresses a rule for a step, the reason kept
on rewrite.  One key is the port's own: ``allow_conversion = int32->int64
-- reason`` lets RPJ103 pass that one widening (torch's index dtype is
int64) and no other.

CLI::

    python -m repro_torch.analysis.torchcheck                # on the card
    python -m repro_torch.analysis.torchcheck --device cpu   # kernel steps left out

Exit 0 when clean (modulo budgets and waivers), 1 on findings, 2 on usage
errors.  The steps run for real at a smoke-sized geometry; on the CPU the
kernel-route steps (``decode_step``, ``cow_copy``) do not exist and are
reported as left out, never traced through the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Set, Tuple

__all__ = [
    "Finding",
    "Budgets",
    "RULE_IDS",
    "RULE_DOCS",
    "load_budgets",
    "format_budgets",
]

RULE_IDS = ("RPJ101", "RPJ102", "RPJ103", "RPJ104", "RPJ105", "RPJ106")

RULE_DOCS = {
    "RPJ101": "in place: a pool storage not returned, or a pool-sized allocation",
    "RPJ102": "materialized-gather: gather output bytes over the step's budget",
    "RPJ103": "dtype-promotion drift: upcast past the planned widest dtype",
    "RPJ104": "retrace-closure: input signature outside the enumerated key set",
    "RPJ105": "memory-budget regression: traced memory over checked-in budget",
    "RPJ106": "collective-traffic budget: a mesh step's collective bytes over budget",
}

#: memory fields gated by RPJ105 (the in-place bytes are recorded beside
#: them, as the JAX record's alias bytes, but not gated)
GATED_MEMORY_FIELDS = (
    "temp_size_in_bytes",
    "argument_size_in_bytes",
    "output_size_in_bytes",
)

DEFAULT_TOLERANCE = 0.5  # the JAX package's tolerance
DEFAULT_WIDEST = "float32"  # the planned widest compute dtype in hot steps

#: itemsize of each dtype name ``allowed_widest`` may take
ITEMSIZE = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "bfloat16": 2, "float16": 2,
    "int32": 4, "float32": 4, "int64": 8, "float64": 8,
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One step finding, reported as ``step: RULE message``."""

    rule: str
    step: str
    message: str

    def format(self) -> str:
        return f"{self.step}: {self.rule} {self.message}"

    def to_json(self) -> Dict[str, str]:
        return {"rule": self.rule, "step": self.step, "message": self.message}


# ---------------------------------------------------------------------------
# Budgets file (torchcheck.budgets)
# ---------------------------------------------------------------------------
#
#   [global]
#   tolerance = 0.50
#   allowed_widest = float32
#
#   [decode_step]
#   temp_size_in_bytes = 1234
#   argument_size_in_bytes = 5678
#   output_size_in_bytes = 91011
#   max_gather_bytes = 1213
#   waive = RPJ102 -- reason
#   allow_conversion = int32->int64 -- reason
#
# Sections are step names from the inventory; `waive` suppresses rules for
# that step (or globally, in [global]); `allow_conversion` lets RPJ103 pass
# the named from->to pairs (`none` for an output no tensor input feeds), a
# reason required.  Regenerate measured values with
# `python -m repro_torch.analysis.torchcheck --write-budgets`.


@dataclasses.dataclass
class Budgets:
    """Parsed ``torchcheck.budgets``: per-step numeric budgets + waivers."""

    steps: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    waivers: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    tolerance: float = DEFAULT_TOLERANCE
    allowed_widest: str = DEFAULT_WIDEST
    #: step -> rule -> the reason its waiver gives
    reasons: Dict[str, Dict[str, str]] = dataclasses.field(default_factory=dict)
    #: step -> (from, to) dtype pair RPJ103 lets pass -> the reason given
    conversions: Dict[str, Dict[Tuple[str, str], str]] = dataclasses.field(
        default_factory=dict)

    def budget(self, step: str, key: str) -> Optional[int]:
        return self.steps.get(step, {}).get(key)

    def waived(self, rule: str, step: str) -> bool:
        return rule in self.waivers.get(step, set()) or (
            rule in self.waivers.get("global", set())
        )

    def conversion_allowed(self, step: str, pair: Tuple[str, str]) -> bool:
        return pair in self.conversions.get(step, {}) or (
            pair in self.conversions.get("global", {})
        )

    def allowed(self, step: str, key: str, value: int) -> bool:
        """Within budget: ``value <= budget * (1 + tolerance)``."""
        b = self.budget(step, key)
        if b is None:
            return False
        return value <= b * (1.0 + self.tolerance)


def _parse_waive(value: str, where: str):
    rules_part, _, reason = value.partition("--")
    rules = {t.strip() for t in rules_part.split(",") if t.strip()}
    unknown = rules - set(RULE_IDS)
    if unknown:
        raise ValueError(f"{where}: unknown rule id(s) in waive: {sorted(unknown)}")
    if not rules:
        raise ValueError(f"{where}: empty waive entry")
    return rules, reason.strip()


def _parse_conversions(value: str, where: str):
    pairs_part, _, reason = value.partition("--")
    pairs = []
    for token in (t.strip() for t in pairs_part.split(",") if t.strip()):
        frm, arrow, to = (t.strip() for t in token.partition("->"))
        if not arrow or (frm not in ITEMSIZE and frm != "none") or to not in ITEMSIZE:
            raise ValueError(f"{where}: allow_conversion wants `from->to` dtype pairs, "
                             f"got {token!r}")
        pairs.append((frm, to))
    if not pairs or not reason.strip():
        raise ValueError(f"{where}: allow_conversion needs a pair and a `-- reason`")
    return pairs, reason.strip()


def load_budgets(path: Path) -> Budgets:
    budgets = Budgets()
    section = None
    for lineno, raw in enumerate(path.read_text(encoding="utf-8").splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        where = f"{path}:{lineno}"
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1].strip()
            if not section:
                raise ValueError(f"{where}: empty section name")
            continue
        if "=" not in line or section is None:
            raise ValueError(f"{where}: expected `key = value` inside a section")
        key, value = (t.strip() for t in line.split("=", 1))
        if key == "waive":
            rules, reason = _parse_waive(value, where)
            budgets.waivers.setdefault(section, set()).update(rules)
            for r in rules:
                budgets.reasons.setdefault(section, {})[r] = reason
        elif key == "allow_conversion":
            pairs, reason = _parse_conversions(value, where)
            for pair in pairs:
                budgets.conversions.setdefault(section, {})[pair] = reason
        elif section == "global" and key == "tolerance":
            budgets.tolerance = float(value)
        elif section == "global" and key == "allowed_widest":
            if value not in ITEMSIZE:
                raise ValueError(f"{where}: unknown dtype {value!r}")
            budgets.allowed_widest = value
        else:
            try:
                budgets.steps.setdefault(section, {})[key] = int(value)
            except ValueError:
                raise ValueError(
                    f"{where}: budget value for {key} must be an int"
                ) from None
    return budgets


def _waive_lines(step: str, waivers, reasons, conversions) -> list:
    lines = []
    for rule in sorted(waivers.get(step, ())):
        reason = reasons.get(step, {}).get(rule, "")
        lines.append(f"waive = {rule}" + (f" -- {reason}" if reason else ""))
    for (frm, to), reason in sorted(conversions.get(step, {}).items()):
        lines.append(f"allow_conversion = {frm}->{to} -- {reason}")
    return lines


def format_budgets(
    measured: Dict[str, Dict[str, int]],
    *,
    tolerance: float = DEFAULT_TOLERANCE,
    allowed_widest: str = DEFAULT_WIDEST,
    waivers: Optional[Dict[str, Set[str]]] = None,
    reasons: Optional[Dict[str, Dict[str, str]]] = None,
    conversions: Optional[Dict[str, Dict[Tuple[str, str], str]]] = None,
) -> str:
    """Serialize measured per-step budgets (keeping waivers, allowed
    conversions and their reasons on rewrite)."""
    lines = [
        "# torchcheck.budgets — budgets for the serving engine's steps,",
        "# traced once each (gather bytes, traced storage sizes).",
        "# Regenerate with: python -m repro_torch.analysis.torchcheck --write-budgets",
        "# `waive = RPJxxx -- reason` suppresses a rule for a step;",
        "# `allow_conversion = from->to -- reason` lets RPJ103 pass that pair alone.",
        "",
        "[global]",
        f"tolerance = {tolerance:.2f}",
        f"allowed_widest = {allowed_widest}",
    ]
    waivers = waivers or {}
    reasons = reasons or {}
    conversions = conversions or {}
    lines += _waive_lines("global", waivers, reasons, conversions)
    for step in sorted((set(measured) | set(waivers) | set(conversions)) - {"global"}):
        lines.append("")
        lines.append(f"[{step}]")
        for key in sorted(measured.get(step, {})):
            lines.append(f"{key} = {measured[step][key]}")
        lines += _waive_lines(step, waivers, reasons, conversions)
    return "\n".join(lines) + "\n"
