"""Fixture tests for the port's lint pass (repro_torch.analysis.staticcheck).

Per rule: a true-positive snippet in torch's form, a true-negative snippet
(the idiom the port actually uses), and pragma suppression -- the twins of
``tests/test_staticcheck.py``'s fixtures.  Plus parity with the JAX linter
on the same sources (pragmas, findings' format and baseline keys, the
baseline file, syntax errors, the framework-neutral rules RPR004 and
RPR005), the CLI, and the acceptance gate that the port lints clean.
"""
import json
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import staticcheck as jax_sc
from repro_torch.analysis.staticcheck import (
    RULE_DOCS,
    RULE_IDS,
    Finding,
    check_paths,
    check_source,
    format_baseline,
    load_baseline,
    parse_pragmas,
    split_by_baseline,
)
from repro_torch.analysis.staticcheck.__main__ import DEFAULT_PATHS, expand_paths, main

REPO = Path(__file__).resolve().parent.parent


def _rules(src, path="src/repro_torch/fake.py", select=None):
    """Rule ids found in a dedented snippet."""
    findings = check_source(textwrap.dedent(src), path=path, rules=select)
    return [f.rule for f in findings]


# --------------------------------------------------------------------------
# RPR001 — use-after-donation (donate=True writes in place)
# --------------------------------------------------------------------------

def test_rpr001_positive_known_donating_call():
    src = """
        def step(self, grads, params, opt_state, lr):
            new_p, new_s = adamw_update(grads, opt_state, params, self.oc, lr, donate=True)
            return params  # written in place, read before rebinding
    """
    found = check_source(textwrap.dedent(src), path="src/repro_torch/fake.py",
                         rules=["RPR001"])
    assert [f.rule for f in found] == ["RPR001"]
    assert "'params'" in found[0].message and "position 2" in found[0].message


def test_rpr001_positive_unknown_callee_donates_every_name():
    src = """
        def drive(data, scale):
            update(data, scale, donate=True)
            return data.sum() + scale  # both names may have been written
    """
    assert _rules(src, select=["RPR001"]) == ["RPR001", "RPR001"]


def test_rpr001_negative_same_statement_rebind():
    src = """
        def step(self, grads, params, opt_state, lr):
            params, opt_state = adamw_update(
                T.unflatten(params, grads), opt_state, params, self.oc, lr,
                donate=True)
            return params, opt_state, {"lr": lr, "oc": self.oc}
    """
    assert _rules(src, select=["RPR001"]) == []


def test_rpr001_negative_rebind_before_read_and_no_donation():
    src = """
        def drive(grads, params, opt_state, lr):
            adamw_update(grads, opt_state, params, OC, lr, donate=True)
            params = fresh()
            opt_state = fresh()
            new = adamw_update(grads, opt_state, params, OC, lr)
            return params.sum(), opt_state, new
    """
    assert _rules(src, select=["RPR001"]) == []


def test_rpr001_noqa():
    src = """
        def drive(data):
            update(data, donate=True)
            return data.sum()  # repro: noqa RPR001 -- test fixture
    """
    assert _rules(src, select=["RPR001"]) == []


# --------------------------------------------------------------------------
# RPR002 — host sync in a hot-loop function
# --------------------------------------------------------------------------

def test_rpr002_positive_all_sync_forms():
    src = """
        import numpy as np
        import torch

        def step(self):  # repro: hot-loop
            a = np.asarray(self.tokens)
            b = np.stack([a, a])
            c = int(self.greedy)
            d = float(self.logits)
            e = self.tokens.item()
            f = self.tokens.tolist()
            g = self.mask.nonzero()
            h = torch.nonzero(self.mask)
            i = torch.unique(self.tokens)
            j = self.logits.masked_select(self.mask)
            return a, b, c, d, e, f, g, h, i, j
    """
    assert _rules(src, select=["RPR002"]) == ["RPR002"] * 10


def test_rpr002_negative_unmarked_function():
    src = """
        import torch

        def intake(self):  # not marked hot: syncs here are fine
            return self.prompt.nonzero().item()
    """
    assert _rules(src, select=["RPR002"]) == []


def test_rpr002_negative_device_side_ops():
    src = """
        import torch

        def step(self):  # repro: hot-loop
            x = torch.argmax(self.logits, -1)   # stays on the device
            y = torch.where(self.mask, x, 0)    # a fixed shape: no sync
            n = int("42")                       # constant: no device value
            return x, y, n
    """
    assert _rules(src, select=["RPR002"]) == []


def test_rpr002_marker_on_preceding_line():
    src = """
        # repro: hot-loop
        def step(self):
            return self.tokens.item()
    """
    assert _rules(src, select=["RPR002"]) == ["RPR002"]


def test_rpr002_noqa():
    src = """
        def step(self):  # repro: hot-loop
            return int(self.done)  # repro: noqa RPR002 -- sanctioned
    """
    assert _rules(src, select=["RPR002"]) == []


# --------------------------------------------------------------------------
# RPR003 — compile / graph capture under a loop
# --------------------------------------------------------------------------

def test_rpr003_positive_loop_and_comprehension():
    src = """
        import torch

        def serve(reqs, fs):
            for r in reqs:
                fn = torch.compile(make_step(r))   # recompiles per request
                g = torch.cuda.CUDAGraph()           # a capture per request
                with torch.cuda.graph(g):
                    fn(r)
            scripted = [torch.jit.script(f) for f in fs]
            traced = {f: torch.jit.trace(f, x) for f in fs}
            return scripted, traced
    """
    assert _rules(src, select=["RPR003"]) == ["RPR003"] * 5


def test_rpr003_negative_hoisted_and_factory():
    src = """
        import functools
        import torch

        @functools.lru_cache(maxsize=None)
        def _decode_fn(cfg):
            return torch.compile(functools.partial(step, cfg))

        def serve(reqs, cfg):
            fn = _decode_fn(cfg)  # memoized: compiled once
            graph = torch.cuda.CUDAGraph()
            for r in reqs:
                fn(r)
                graph.replay()
    """
    assert _rules(src, select=["RPR003"]) == []


def test_rpr003_negative_def_inside_loop():
    src = """
        import torch

        def outer(items):
            for it in items:
                def helper():
                    return torch.compile(f)  # constructed only when called
    """
    assert _rules(src, select=["RPR003"]) == []


def test_rpr003_noqa():
    src = """
        import torch

        def sweep(cfgs):
            for cfg in cfgs:
                fn = torch.compile(step)  # repro: noqa RPR003 -- one-off sweep
                fn(cfg)
    """
    assert _rules(src, select=["RPR003"]) == []


# --------------------------------------------------------------------------
# RPR004 — family branch outside the registry
# --------------------------------------------------------------------------

_FAMILY_SRC = """
    def pick(cfg):
        if cfg.family == "mla":
            return 1
        if cfg.family in ("ssm", "hybrid"):
            return 2
        if "encdec" != cfg.family:
            return 3
"""


def test_rpr004_positive_eq_and_membership():
    assert _rules(_FAMILY_SRC, select=["RPR004"]) == ["RPR004"] * 3


def test_rpr004_negative_in_registry_file():
    assert _rules(_FAMILY_SRC, path="src/repro_torch/models/adapters.py",
                  select=["RPR004"]) == []


def test_rpr004_negative_unrelated_string_compare():
    src = """
        def check(mode, name):
            if mode == "ssm":          # no family-ish subject in sight
                return 1
            if name == "dense_layer":  # not a family literal
                return 2
    """
    assert _rules(src, select=["RPR004"]) == []


def test_rpr004_noqa_line_and_file():
    line = """
        def pick(cfg):
            return cfg.family == "mla"  # repro: noqa RPR004 -- fixture
    """
    assert _rules(line, select=["RPR004"]) == []
    file_wide = """
        # repro: noqa-file RPR004 -- per-family math module
        def pick(cfg):
            a = cfg.family == "mla"
            b = cfg.family == "ssm"
            return a or b
    """
    assert _rules(file_wide, select=["RPR004"]) == []


# --------------------------------------------------------------------------
# RPR005 — stray debug output in src/
# --------------------------------------------------------------------------

def test_rpr005_positive_in_src():
    src = """
        import pdb

        def f(x):
            print(x)
            breakpoint()
            pdb.set_trace()
    """
    assert _rules(src, select=["RPR005"]) == ["RPR005"] * 3


def test_rpr005_negative_outside_src():
    src = """
        def f(x):
            print(x)
    """
    assert _rules(src, path="tests/test_torch_fake.py", select=["RPR005"]) == []
    assert _rules(src, path="chip_smoke.py", select=["RPR005"]) == []


def test_rpr005_noqa_file():
    src = """
        # repro: noqa-file RPR005 -- CLI entry point
        def report(x):
            print(x)
            print(x * 2)
    """
    assert _rules(src, select=["RPR005"]) == []


# --------------------------------------------------------------------------
# RPR006 — explicit device->host transfer in a hot-loop function
# --------------------------------------------------------------------------

def test_rpr006_positive_transfers():
    src = """
        import numpy as np
        import torch

        def step(self, x):  # repro: hot-loop
            a = x.cpu()
            b = x.numpy()
            c = x.to("cpu")
            d = x.to(device="cpu")
            e = x.to(torch.device("cpu"))
            torch.cuda.synchronize()
            self.stream.synchronize()
            self.done_event.synchronize()
            f = np.array(x)
            g = x.cpu().numpy()        # one transfer, reported once
            return a, b, c, d, e, f, g
    """
    assert _rules(src, select=["RPR006"]) == ["RPR006"] * 10


def test_rpr006_negative_outside_hot_loop_and_device_moves():
    src = """
        import numpy as np

        def report(x):
            return np.array(x.cpu())

        def step(self, x):  # repro: hot-loop
            y = x.to(self.device, non_blocking=True)
            z = x.to(torch.float32)
            return y, z, np.array([0, 1, 2])
    """
    assert _rules(src, select=["RPR006"]) == []


def test_rpr006_pragma_suppression():
    src = """
        def step(self, x):  # repro: hot-loop
            return x.cpu().numpy()  # repro: noqa RPR006 -- sanctioned sync
    """
    assert _rules(src, select=["RPR006"]) == []


# --------------------------------------------------------------------------
# RPR007 — hard-coded device selection in serve/
# --------------------------------------------------------------------------

_SERVE_PATH = "src/repro_torch/serve/fake.py"


def test_rpr007_positive_device_literals():
    src = """
        import torch

        def place(params, pool):
            dev = torch.device("cuda:0")
            other = torch.device("cuda", 1)
            params = params.cuda()
            pool = pool.cuda(0)
            torch.cuda.set_device(1)
            return pool.to("cuda:1")
    """
    assert _rules(src, path=_SERVE_PATH, select=["RPR007"]) == ["RPR007"] * 6


def test_rpr007_negative_engine_device():
    src = """
        import torch

        def place(params, pool, device, rank):
            params = params.to(device)
            pool = pool.cuda(device)
            torch.cuda.set_device(device)
            n = torch.cuda.device_count()
            return params, pool, torch.device("cuda", rank), n, "cuda"
    """
    assert _rules(src, path=_SERVE_PATH, select=["RPR007"]) == []


def test_rpr007_negative_outside_serve_tree():
    src = """
        import torch
        dev = torch.device("cuda:0")
    """
    assert _rules(src, path="src/repro_torch/launch/fake.py", select=["RPR007"]) == []
    assert _rules(src, path="tests/serve/fake.py", select=["RPR007"]) == []


def test_rpr007_noqa():
    src = """
        def place(x):
            return x.cuda()  # repro: noqa RPR007 -- host staging
    """
    assert _rules(src, path=_SERVE_PATH, select=["RPR007"]) == []


# --------------------------------------------------------------------------
# Parity with the JAX linter on the same sources
# --------------------------------------------------------------------------

_PRAGMA_SRC = textwrap.dedent("""
    x = 1  # repro: noqa RPR001, RPR004 -- two rules
    y = 2  # repro: noqa
    # repro: noqa-file RPR005 -- whole file
    # repro: hot-loop
    def f():
        pass
    z = 3  # repro: this is prose, not a pragma
""")


def test_pragma_parsing_matches_jax():
    p, q = parse_pragmas(_PRAGMA_SRC), jax_sc.parse_pragmas(_PRAGMA_SRC)
    assert p.line_noqa == q.line_noqa and p.file_noqa == q.file_noqa
    assert p.hot_lines == q.hot_lines == {5}
    assert p.line_noqa[2] == {"RPR001", "RPR004"}
    assert p.line_noqa[3] == set(RULE_IDS)  # bare noqa: all rules
    assert p.suppressed("RPR005", 999)  # file-wide, any line


@pytest.mark.parametrize("rule", ["RPR999", "RPT002"])
def test_pragma_unknown_rule_rejected_by_both(rule):
    src = f"x = 1  # repro: noqa {rule}\n"
    with pytest.raises(ValueError, match="unknown rule"):
        check_source(src, path="src/x.py")
    with pytest.raises(ValueError, match="unknown rule"):
        jax_sc.check_source(src, path="src/x.py")


def test_rule_ids_are_the_jax_ids():
    assert RULE_IDS == jax_sc.RULE_IDS
    assert set(RULE_IDS) == set(RULE_DOCS)
    from repro_torch.analysis.staticcheck.rules import RULES
    assert set(RULES) == set(RULE_IDS)


def test_finding_format_and_baseline_key_match_jax():
    kw = dict(rule="RPR005", path="src/a.py", line=3, col=4, message="m",
              snippet="   print(x)  ")
    mine, theirs = Finding(**kw), jax_sc.Finding(**kw)
    assert mine.format() == theirs.format() == "src/a.py:3:4: RPR005 m"
    assert mine.baseline_key() == theirs.baseline_key() == "RPR005|src/a.py|print(x)"


def test_baseline_roundtrip_and_jax_file(tmp_path):
    f1 = Finding(rule="RPR005", path="src/a.py", line=3, col=0,
                 message="m", snippet="  print(x)")
    f2 = Finding(rule="RPR004", path="src/b.py", line=7, col=4,
                 message="m", snippet='if cfg.family == "mla":')
    bl = tmp_path / "staticcheck_torch.baseline"
    bl.write_text(format_baseline([f1, f2]))
    entries = load_baseline(bl)
    assert entries == {f1.baseline_key(), f2.baseline_key()}
    # the JAX linter's file reads the same, entry for entry
    jbl = tmp_path / "staticcheck.baseline"
    jbl.write_text(jax_sc.format_baseline([jax_sc.Finding(**vars(f)) for f in (f1, f2)]))
    assert jax_sc.load_baseline(jbl) == load_baseline(jbl) == entries
    # line numbers may drift without invalidating the baseline
    moved = Finding(rule="RPR005", path="src/a.py", line=30, col=2,
                    message="m", snippet="    print(x)")
    new, old = split_by_baseline([moved, f2], entries)
    assert new == [] and old == [moved, f2]
    # an edited line is a NEW finding
    edited = Finding(rule="RPR005", path="src/a.py", line=3, col=0,
                     message="m", snippet="print(y)")
    new, _ = split_by_baseline([edited], entries)
    assert new == [edited]


@pytest.mark.parametrize("src", ["def broken(:\n", "x = (1,\n", "if True\n    pass\n"])
def test_syntax_error_findings_match_jax(src):
    mine = check_source(src, path="src/x.py")
    theirs = jax_sc.check_source(src, path="src/x.py")
    assert len(mine) == 1 and mine[0].rule == "RPR000"
    assert [(f.rule, f.line, f.col, f.message) for f in mine] == \
        [(f.rule, f.line, f.col, f.message) for f in theirs]


_NEUTRAL_SOURCES = {
    "family": _FAMILY_SRC,
    "family_noqa": """
        # repro: noqa-file RPR004 -- fixture
        def pick(cfg):
            return cfg.attn_type == "swa" or cfg.kind in ("moe",)
    """,
    "family_unrelated": """
        def check(mode):
            return mode == "ssm" and kind_of(mode) == "dense"
    """,
    "debug": """
        def f(x):
            print(x)
            breakpoint()
            return x  # repro: noqa RPR005 -- fixture
    """,
}


@pytest.mark.parametrize("path", ["src/repro_torch/fake.py", "tests/test_torch_fake.py",
                                  "src/repro_torch/models/adapters.py"])
@pytest.mark.parametrize("name", sorted(_NEUTRAL_SOURCES))
def test_rpr004_rpr005_findings_match_jax(name, path):
    src = textwrap.dedent(_NEUTRAL_SOURCES[name])
    for rule in ("RPR004", "RPR005"):
        mine = check_source(src, path=path, rules=[rule])
        theirs = jax_sc.check_source(src, path=path, rules=[rule])
        if rule == "RPR004" and path.endswith("adapters.py"):
            # each linter exempts its own package's registry
            assert mine == [] and theirs == [f for f in theirs if f.rule == rule]
            continue
        assert [(f.rule, f.line, f.col) for f in mine] == \
            [(f.rule, f.line, f.col) for f in theirs]


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_format_json(tmp_path, capsys):
    bad = tmp_path / "src" / "repro_torch" / "fake.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(x):\n    print(x)\n", encoding="utf-8")
    rc = main([str(bad), "--format", "json", "--no-baseline"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert report["status"] == "findings" and report["n_new"] == 1
    assert report["findings"][0]["rule"] == "RPR005"
    assert report["findings"][0]["line"] == 2

    good = tmp_path / "src" / "repro_torch" / "ok.py"
    good.write_text("def f(x):\n    return x\n", encoding="utf-8")
    rc = main([str(good), "--format", "json", "--no-baseline"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report == {
        "tool": "staticcheck", "status": "clean", "n_new": 0,
        "n_baselined": 0, "findings": [],
    }


def test_cli_exit_codes(tmp_path, capsys, monkeypatch):
    assert main(["--list-rules"]) == 0
    assert main(["--select", "RPR999"]) == 2
    assert main([str(tmp_path / "missing.py")]) == 2
    bad = tmp_path / "src" / "bad.py"
    bad.parent.mkdir()
    bad.write_text("x = 1  # repro: noqa RPT001\n", encoding="utf-8")
    assert main([str(bad)]) == 2
    # a baselined finding passes; --write-baseline writes it
    dbg = tmp_path / "src" / "dbg.py"
    dbg.write_text("print(1)\n", encoding="utf-8")
    bl = tmp_path / "b.baseline"
    assert main([str(dbg), "--baseline", str(bl), "--write-baseline"]) == 0
    assert main([str(dbg), "--baseline", str(bl)]) == 0
    assert main([str(dbg), "--baseline", str(bl), "--no-baseline"]) == 1
    capsys.readouterr()
    # the default paths, from the repository root
    monkeypatch.chdir(REPO)
    assert main([]) == 0
    assert "staticcheck: clean" in capsys.readouterr().out


def test_default_paths_cover_the_port():
    paths = expand_paths([str(REPO / p) for p in DEFAULT_PATHS])
    assert str(REPO / "chip_smoke.py") in paths
    assert str(REPO / "tests" / "test_torch_staticcheck.py") in paths
    assert any(p.endswith("torch_quickstart.py") for p in paths)
    assert not any(Path(p).name.startswith("test_") and "torch" not in Path(p).name
                   for p in paths)


# --------------------------------------------------------------------------
# acceptance gate: the port lints clean against the empty baseline
# --------------------------------------------------------------------------

def test_tree_is_clean():
    """The port's default paths lint clean (fix or pragma findings — the
    checked-in baseline stays empty)."""
    findings = check_paths(expand_paths([str(REPO / p) for p in DEFAULT_PATHS]))
    baseline = load_baseline(REPO / "staticcheck_torch.baseline")
    assert baseline == set()
    rel = [
        Finding(f.rule, str(Path(f.path).relative_to(REPO)), f.line, f.col,
                f.message, f.snippet)
        for f in findings
    ]
    new, _ = split_by_baseline(rel, baseline)
    assert not new, "\n".join(f.format() for f in new)
