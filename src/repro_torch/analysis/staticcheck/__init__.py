"""repro_torch.analysis.staticcheck -- the port's repo-specific lint pass.

Counterpart of ``repro.analysis.staticcheck``: the same AST pass, the same
rule ids and meanings, the same pragma grammar (one ``# repro: noqa RPR002
-- reason`` serves both linters), with each rule reading PyTorch's forms of
the hazard.  The serving and training paths' invariants (in-place updates
not read back by mistake, no host syncs in the hot loop, no recompiles or
graph captures built per iteration, family dispatch only through the
adapter registry, placement through the mesh) are invisible to generic
linters:

===========  ==================================================================
rule id      what it catches
===========  ==================================================================
``RPR001``   use-after-donation: a tensor passed to a ``donate=True`` call
             (written in place, as the JAX package donates it) is read
             again before rebinding
``RPR002``   host sync (``np.asarray`` / ``.item()`` / ``.tolist()`` /
             ``float()`` / ``int()`` / ``bool()`` / ``np.stack``) or a
             data-dependent shape that syncs on CUDA (``.nonzero()`` /
             ``torch.nonzero`` / ``torch.unique`` / ``masked_select``)
             inside a function marked ``# repro: hot-loop``
``RPR003``   ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace`` /
             ``torch.cuda.CUDAGraph()`` / ``torch.cuda.graph(...)`` built
             inside a loop or comprehension
``RPR004``   comparison against a layer-family literal outside the adapter
             registry (``src/repro_torch/models/adapters.py``)
``RPR005``   stray ``print`` / ``breakpoint()`` / ``pdb.set_trace()`` in
             ``src/``
``RPR006``   explicit device->host transfer or wait (``.cpu()`` /
             ``.numpy()`` / ``.to("cpu")`` / ``torch.cuda.synchronize()`` /
             a stream's or event's ``.synchronize()`` / ``np.array(x)``)
             inside a ``# repro: hot-loop`` function
``RPR007``   hard-coded device selection in the serving stack (``"cuda:0"``
             literals / ``torch.device("cuda", 0)`` / ``.cuda()`` with no
             device / ``torch.cuda.set_device(0)`` under ``src/.../serve``):
             a mesh rank places on its own device
===========  ==================================================================

Suppression pragmas (trailing comments), as in the JAX package:

- ``# repro: noqa RPR002 -- justification``   suppress rule(s) on this line
- ``# repro: noqa``                           suppress all rules on this line
- ``# repro: noqa-file RPR004 -- why``        suppress rule(s) in this file
- ``# repro: hot-loop``                       mark the next/current ``def`` as
  a hot-loop function (enables RPR002 and RPR006 inside it)

CLI::

    python -m repro_torch.analysis.staticcheck      # the port's default paths

Exit 0 when clean (modulo the checked-in ``staticcheck_torch.baseline``), 1
on new findings, 2 on usage errors.
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "FilePragmas",
    "check_source",
    "check_paths",
    "iter_python_files",
    "load_baseline",
    "format_baseline",
    "RULE_IDS",
    "RULE_DOCS",
]

RULE_IDS = (
    "RPR001", "RPR002", "RPR003", "RPR004", "RPR005", "RPR006", "RPR007",
)

RULE_DOCS = {
    "RPR001": "use-after-donation: tensor given to donate=True read before rebinding",
    "RPR002": "host sync inside a `# repro: hot-loop` function",
    "RPR003": "torch.compile / jit / CUDA graph constructed inside a loop",
    "RPR004": "layer-family branch outside the adapter registry",
    "RPR005": "stray print / breakpoint() / pdb.set_trace() in src/",
    "RPR006": "explicit device->host transfer in a `# repro: hot-loop` function",
    "RPR007": "hard-coded device selection (cuda:N, .cuda(), set_device) in serve/",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, reported as ``path:line:col: RULE message``."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def baseline_key(self) -> str:
        """Line-number-independent identity used by the baseline file."""
        return f"{self.rule}|{self.path}|{self.snippet.strip()}"


# ---------------------------------------------------------------------------
# Pragma parsing
# ---------------------------------------------------------------------------

_PRAGMA_RE = re.compile(
    r"#\s*repro:\s*(?P<kind>noqa-file|noqa|hot-loop)"
    r"(?P<rules>[ \tA-Z0-9,]*)"
    r"(?:--.*)?$"
)

_ALL_RULES = frozenset(RULE_IDS)


@dataclasses.dataclass
class FilePragmas:
    """Per-file pragma state extracted from comments via tokenize."""

    #: line -> rule ids suppressed on that line (``_ALL_RULES`` for bare noqa)
    line_noqa: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)
    #: rule ids suppressed for the whole file
    file_noqa: Set[str] = dataclasses.field(default_factory=set)
    #: lines carrying a ``# repro: hot-loop`` marker
    hot_lines: Set[int] = dataclasses.field(default_factory=set)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_noqa:
            return True
        return rule in self.line_noqa.get(line, ())


def _parse_rule_list(text: str) -> Set[str]:
    rules = {t for t in re.split(r"[,\s]+", text.strip()) if t}
    unknown = rules - _ALL_RULES
    if unknown:
        raise ValueError(f"unknown rule id(s) in pragma: {sorted(unknown)}")
    return rules or set(_ALL_RULES)


def parse_pragmas(source: str, path: str = "<string>") -> FilePragmas:
    pragmas = FilePragmas()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [t for t in tokens if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, SyntaxError):  # pragma: no cover - defensive
        return pragmas
    for tok in comments:
        m = _PRAGMA_RE.match(tok.string)
        if not m:
            continue
        kind = m.group("kind")
        line = tok.start[0]
        if kind == "hot-loop":
            pragmas.hot_lines.add(line)
            continue
        try:
            rules = _parse_rule_list(m.group("rules"))
        except ValueError as e:
            raise ValueError(f"{path}:{line}: {e}") from None
        if kind == "noqa-file":
            pragmas.file_noqa |= rules
        else:
            pragmas.line_noqa.setdefault(line, set()).update(rules)
    return pragmas


# ---------------------------------------------------------------------------
# Running rules over sources / paths
# ---------------------------------------------------------------------------


def check_source(
    source: str,
    path: str = "<string>",
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Lint one source string; returns unsuppressed findings sorted by line."""
    import ast

    from . import rules as _rules

    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [
            Finding(
                rule="RPR000",
                path=path,
                line=e.lineno or 1,
                col=e.offset or 0,
                message=f"syntax error: {e.msg}",
            )
        ]
    pragmas = parse_pragmas(source, path)
    lines = source.splitlines()
    ctx = _rules.RuleContext(path=path, source_lines=lines, pragmas=pragmas)
    selected = rules if rules is not None else RULE_IDS
    findings: List[Finding] = []
    for rule_id in selected:
        for f in _rules.RULES[rule_id](tree, ctx):
            if not pragmas.suppressed(f.rule, f.line):
                findings.append(f)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


_SKIP_DIRS = {".git", "__pycache__", ".ruff_cache", ".pytest_cache", "build"}


def iter_python_files(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_file() and path.suffix == ".py":
            out.append(path)
        elif path.is_dir():
            for f in sorted(path.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    out.append(f)
    return out


def check_paths(
    paths: Iterable[str], rules: Optional[Sequence[str]] = None
) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        src = f.read_text(encoding="utf-8")
        findings.extend(check_source(src, path=str(f), rules=rules))
    return findings


# ---------------------------------------------------------------------------
# Baseline file
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> Set[str]:
    """Baseline entries are ``RULE|path|stripped-source-line`` lines."""
    entries: Set[str] = set()
    for raw in path.read_text(encoding="utf-8").splitlines():
        line = raw.strip()
        if line and not line.startswith("#"):
            entries.add(line)
    return entries


def format_baseline(findings: Sequence[Finding]) -> str:
    header = (
        "# staticcheck_torch baseline — known findings tolerated by CI.\n"
        "# Regenerate with: python -m repro_torch.analysis.staticcheck "
        "--write-baseline <paths>\n"
        "# One `RULE|path|stripped source line` entry per finding; prefer\n"
        "# fixing or pragma-ing findings over baselining them.\n"
    )
    body = "".join(
        f"{k}\n" for k in sorted({f.baseline_key() for f in findings})
    )
    return header + body


def split_by_baseline(
    findings: Sequence[Finding], baseline: Set[str]
) -> Tuple[List[Finding], List[Finding]]:
    """Return (new, baselined) findings."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if f.baseline_key() in baseline else new).append(f)
    return new, old
