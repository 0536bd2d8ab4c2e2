"""Tests of the port's step linter (repro_torch.analysis.torchcheck).

Parity with the JAX inventory (``repro.analysis.jaxcheck``, compiled once):
the step names, the chunk closure and plans, argument bytes (but for the
4 B of each scalar the port passes as a Python int), output leaf bytes, the
in-place bytes against ``alias_size_in_bytes`` and the reference decode's
largest gather.  Per RPJ rule: a seeded finding and the clean counterpart
(an f64 upcast, widenings with no ``_to_copy`` and a probe signature leak
among them), waivers and allowed conversions, the
budgets file's round trip, the CLI's exit codes, the CPU inventory clean
against ``torchcheck.budgets``, and the ``1 x 2`` mesh inventory traced as
rank 0 of a fake group.
"""
import json
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.torchcheck import (
    RULE_IDS,
    Budgets,
    format_budgets,
    load_budgets,
)
from repro_torch.analysis.torchcheck.__main__ import main
from repro_torch.analysis.torchcheck.harness import (
    ProbeSet,
    StepSpec,
    leaves_with_path,
    measure,
    signature,
    trace,
)
from repro_torch.analysis.torchcheck.inventory import (
    KERNEL_STEPS,
    InventoryConfig,
    serving_inventory,
)
from repro_torch.analysis.torchcheck.rules import RULES, run_rules

REPO = Path(__file__).resolve().parent.parent
JAX_MESH_DECODE_COLLECTIVE_BYTES = 9528  # jaxcheck_mesh.budgets, decode_step


def _findings(spec, budgets=None, select=None):
    ts = trace(spec)
    budgets = budgets or Budgets()
    out = []
    for rid in select or RULE_IDS:
        out.extend(f for f in RULES[rid]([ts], None, budgets)
                   if not budgets.waived(f.rule, f.step))
    return out


# --------------------------------------------------------------------------
# the inventories, traced and compiled once
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port():
    with serving_inventory(InventoryConfig(device="cpu")) as inv:
        steps = {spec.name: trace(spec) for spec in inv.specs}
    return inv, steps


@pytest.fixture(scope="module")
def jax_inv():
    """The JAX inventory, compiled: {name: (measure record, output leaf
    bytes)} and the inventory."""
    import jax

    from repro.analysis.jaxcheck.harness import compile_step
    from repro.analysis.jaxcheck.harness import measure as jax_measure
    from repro.analysis.jaxcheck.inventory import serving_inventory as jax_serving_inventory

    inv = jax_serving_inventory()
    out = {}
    for spec in inv.specs:
        record = jax_measure(compile_step(spec))
        shapes = jax.eval_shape(spec.fn, *spec.args)
        leaf_bytes = sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(shapes))
        out[spec.name] = (record, leaf_bytes)
    return inv, out


# --------------------------------------------------------------------------
# parity with the JAX inventory
# --------------------------------------------------------------------------

def test_step_names_and_left_out(port, jax_inv):
    inv, steps = port
    assert set(steps) | set(inv.left_out) == set(jax_inv[1])
    assert sorted(inv.left_out) == sorted(KERNEL_STEPS)
    assert all("card" in why for why in inv.left_out.values())


def test_chunk_closure_and_plans_match_jax(port, jax_inv):
    inv, _ = port
    j = jax_inv[0]
    assert inv.chunk_size == j.chunk_size == 8
    assert tuple(inv.chunk_closure) == tuple(j.chunk_closure) == (1, 2, 4, 8)
    assert inv.chunk_plans == j.chunk_plans == {3: [4], 8: [8], 13: [8, 8]}


_CPU_STEPS = ("decode_step_reference", "prefill_chunk_1", "prefill_chunk_2",
              "prefill_chunk_4", "prefill_chunk_8", "cow_copy_reference", "install")


@pytest.mark.parametrize("name", _CPU_STEPS)
def test_bytes_match_jax(port, jax_inv, name):
    """Arguments: JAX's but for 4 B a scalar the port passes as a Python
    int; outputs: JAX's leaf bytes; in place: JAX's alias bytes."""
    ts = port[1][name]
    record, leaf_bytes = jax_inv[1][name]
    ints = sum(isinstance(leaf, int) for _, leaf in leaves_with_path(ts.spec.args))
    assert ts.memory["argument_size_in_bytes"] == record["argument_size_in_bytes"] - 4 * ints
    assert ts.memory["output_size_in_bytes"] == leaf_bytes
    assert ts.memory["alias_size_in_bytes"] == record["alias_size_in_bytes"] == 208896


def test_decode_numbers_match_jax(port, jax_inv):
    ts = port[1]["decode_step_reference"]
    record, _ = jax_inv[1]["decode_step_reference"]
    assert ts.memory["argument_size_in_bytes"] == record["argument_size_in_bytes"] == 1144786
    assert measure(ts)["max_gather_bytes"] == record["max_gather_bytes"] == 49152
    # JAX's Pallas decode gathers the embedding rows alone; on the card the
    # port's kernel route must too (chip_smoke.py phase 20)
    assert jax_inv[1]["decode_step"][0]["max_gather_bytes"] == 2 * 96 * 4
    assert jax_inv[1]["cow_copy_reference"][0]["argument_size_in_bytes"] == 208904


def test_cpu_inventory_is_clean_against_the_budgets(port):
    inv, steps = port
    budgets = load_budgets(REPO / "torchcheck.budgets")
    findings = run_rules(list(steps.values()), inv, budgets)
    assert not findings, "\n".join(f.format() for f in findings)
    assert set(budgets.steps) <= set(steps) | set(inv.left_out)
    # no rule is waived; RPJ103 passes only widenings to torch's index
    # dtype, each pair with its reason
    assert not budgets.waivers
    for step, pairs in budgets.conversions.items():
        assert {to for _, to in pairs} == {"int64"}
        assert all("index dtype" in why for why in pairs.values())
    for ts in steps.values():
        wide = {(c["from"], c["to"]) for c in ts.conversions if c["to_itemsize"] > 4}
        assert all(budgets.conversion_allowed(ts.name, pair) for pair in wide)
    assert all(not ts.launches for ts in steps.values())


# --------------------------------------------------------------------------
# RPJ101 — in place
# --------------------------------------------------------------------------

def _pool():
    return {"k": torch.zeros(64, 8), "v": torch.zeros(64, 8)}


def test_rpj101_seeded_copy():
    spec = StepSpec(name="copy", fn=lambda pool: {k: v.clone() + 1 for k, v in pool.items()},
                    args=(_pool(),), donate_argnums=(0,))
    found = _findings(spec, select=["RPJ101"])
    assert [f.rule for f in found] == ["RPJ101", "RPJ101"]
    assert "update became a copy" in found[0].message and "['k']" in found[0].message
    assert "pool leaf's size" in found[1].message


def test_rpj101_clean_in_place_and_waiver():
    spec = StepSpec(name="ok", fn=lambda pool: {k: v.add_(1) for k, v in pool.items()},
                    args=(_pool(),), donate_argnums=(0,))
    assert _findings(spec, select=["RPJ101"]) == []
    bad = StepSpec(name="copy", fn=lambda pool: {k: v + 1 for k, v in pool.items()},
                   args=(_pool(),), donate_argnums=(0,))
    assert _findings(bad, Budgets(waivers={"copy": {"RPJ101"}}), select=["RPJ101"]) == []


# --------------------------------------------------------------------------
# RPJ102 — materialized gather
# --------------------------------------------------------------------------

def _gather_spec():
    # gathers 512 rows of 256 floats = 512 KiB output
    return StepSpec(name="big_gather", fn=lambda table, idx: table[idx],
                    args=(torch.zeros(1024, 256), torch.zeros(512, dtype=torch.int64)))


def test_rpj102_seeded_over_budget_and_unbudgeted():
    found = _findings(_gather_spec(), Budgets(steps={"big_gather": {"max_gather_bytes": 1024}}),
                      select=["RPJ102"])
    assert [f.rule for f in found] == ["RPJ102"] and "exceeds budget" in found[0].message
    found = _findings(_gather_spec(), select=["RPJ102"])
    assert "no max_gather_bytes budget" in found[0].message


@pytest.mark.parametrize("op", [
    lambda t, i: t[i], lambda t, i: torch.index_select(t, 0, i),
    lambda t, i: torch.nn.functional.embedding(i, t),
    lambda t, i: torch.gather(t, 0, i[:, None].expand(-1, 256)),
    lambda t, i: torch.take(t, i)[:, None].expand(-1, 256).contiguous(),
], ids=["index", "index_select", "embedding", "gather", "take"])
def test_rpj102_sees_each_gather_form(op):
    spec = StepSpec(name="g", fn=op,
                    args=(torch.zeros(1024, 256), torch.zeros(512, dtype=torch.int64)))
    rec = measure(trace(spec))
    assert rec["max_gather_bytes"] in (512 * 256 * 4, 512 * 4)


def test_rpj102_clean_within_budget_and_scatters_not_counted():
    budgets = Budgets(steps={"big_gather": {"max_gather_bytes": 512 * 1024}})
    assert _findings(_gather_spec(), budgets, select=["RPJ102"]) == []
    scatter = StepSpec(name="s", fn=lambda t, i, v: t.index_put_((i,), v),
                       args=(torch.zeros(1024, 256), torch.zeros(512, dtype=torch.int64),
                             torch.ones(512, 256)))
    assert measure(trace(scatter))["max_gather_bytes"] == 0


# --------------------------------------------------------------------------
# RPJ103 — dtype-promotion drift
# --------------------------------------------------------------------------

def test_rpj103_seeded_f64_upcast():
    spec = StepSpec(name="upcast", fn=lambda x: x.double() * 2.0,
                    args=(torch.zeros(16),))
    found = _findings(spec, select=["RPJ103"])
    assert [f.rule for f in found] == ["RPJ103"]
    assert "float64" in found[0].message


_I32 = torch.zeros(16, dtype=torch.int32)


_F32_F64 = ("float32", "float64")
_NEW_F64 = ("none", "float64")


@pytest.mark.parametrize("fn,args,pairs", [
    # the f64 factory, then the f32 operand promoted to it
    (lambda x: x * torch.ones(16, dtype=torch.float64), (torch.zeros(16),),
     [_NEW_F64, _F32_F64]),
    (lambda x, y: x * y, (torch.zeros(16), torch.zeros(16, dtype=torch.float64)), [_F32_F64]),
    (lambda: torch.arange(16, dtype=torch.float64), (), [_NEW_F64]),
    (lambda a, b: a + b, (_I32, torch.zeros(16, dtype=torch.int64)), [("int32", "int64")]),
    (lambda a: a.sum(), (_I32,), [("int32", "int64")]),
    (lambda x: torch.zeros_like(x, dtype=torch.float64).copy_(x), (torch.zeros(16),),
     [_F32_F64]),
], ids=["promoted_operand", "promoted_argument", "factory", "int_promotion",
        "widening_reduction", "copy_"])
def test_rpj103_seeded_implicit_widening(fn, args, pairs):
    """Widenings with no ``_to_copy``: JAX's jaxpr shows each as a
    ``convert_element_type``, so the port's rule must see them too."""
    spec = StepSpec(name="implicit", fn=fn, args=args)
    found = _findings(spec, select=["RPJ103"])
    assert [f.rule for f in found] == ["RPJ103"] * len(pairs)
    assert all(f"{a} -> {b}" in f.message for f, (a, b) in zip(found, pairs))
    allowed = Budgets(conversions={"implicit": {pair: "seeded" for pair in pairs}})
    assert _findings(spec, allowed, select=["RPJ103"]) == []


def test_rpj103_clean_f32_converts_and_waiver():
    spec = StepSpec(name="ok", fn=lambda x: x.float() + 1.0,
                    args=(torch.zeros(16, dtype=torch.int32),))
    assert _findings(spec, select=["RPJ103"]) == []
    widen = StepSpec(name="w", fn=lambda x: x.long(), args=(torch.zeros(16, dtype=torch.int32),))
    assert [f.rule for f in _findings(widen, select=["RPJ103"])] == ["RPJ103"]
    assert _findings(widen, Budgets(waivers={"w": {"RPJ103"}}), select=["RPJ103"]) == []
    # an allowed pair passes that pair alone: an f64 upcast beside it is
    # still reported, in the step and under the global allowance
    index = {("int32", "int64"): "index dtype"}
    assert _findings(widen, Budgets(conversions={"w": index}), select=["RPJ103"]) == []
    both = StepSpec(name="w", fn=lambda x: (x.long(), x.double()),
                    args=(torch.zeros(16, dtype=torch.int32),))
    for budgets in (Budgets(conversions={"w": index}), Budgets(conversions={"global": index})):
        found = _findings(both, budgets, select=["RPJ103"])
        assert [f.rule for f in found] == ["RPJ103"] and "int32 -> float64" in found[0].message


# --------------------------------------------------------------------------
# RPJ104 — retrace closure
# --------------------------------------------------------------------------

def test_rpj104_seeded_plan_escapes_closure():
    spec = StepSpec(name="escape", fn=lambda x: x * 2.0, args=(torch.zeros(8),),
                    signature_plan=(8, 3), signature_closure=(1, 2, 4, 8))
    found = _findings(spec, select=["RPJ104"])
    assert [f.rule for f in found] == ["RPJ104"] and "[3]" in found[0].message


def test_rpj104_seeded_probe_signature_leak():
    # the probe feeds two dtypes through one step -> 2 signatures, not 1
    spec = StepSpec(name="leak", fn=lambda x: x * 2, args=(torch.zeros(8),),
                    probe=ProbeSet(keys=(0, 1), expected_entries=1, make_args=lambda k: (
                        torch.zeros(8, dtype=torch.float32 if k == 0 else torch.int32),)))
    found = _findings(spec, select=["RPJ104"])
    assert [f.rule for f in found] == ["RPJ104"] and "signature leak" in found[0].message


def test_rpj104_clean_probe_and_signature():
    spec = StepSpec(name="ok", fn=lambda x, n: x * n, args=(torch.zeros(8), 1),
                    signature_plan=(8,), signature_closure=(8,),
                    probe=ProbeSet(keys=(0, 1), expected_entries=1,
                                   make_args=lambda k: (torch.zeros(8), k + 2)))
    assert _findings(spec, select=["RPJ104"]) == []
    # a Python int's value is not its signature, its type is
    assert signature((torch.zeros(2), 3)) == signature((torch.ones(2), 5))
    assert signature((torch.zeros(2), 3)) != signature((torch.zeros(2), 3.0))
    assert signature({"a": torch.zeros(2)}) != signature({"b": torch.zeros(2)})


def test_port_probes_present_the_planned_signatures(port):
    """decode 1, the full chunk 2 (planned [4, 8, 8, 8]), COW 1."""
    inv, steps = port
    want = {"decode_step_reference": 1, "prefill_chunk_8": 2, "cow_copy_reference": 1}
    got = {name: ts.spec.probe.expected_entries for name, ts in steps.items()
           if ts.spec.probe is not None}
    assert got == want
    assert tuple(steps["prefill_chunk_8"].spec.probe.keys) == (4, 8, 8, 8)
    assert RULES["RPJ104"](list(steps.values()), inv, Budgets()) == []


# --------------------------------------------------------------------------
# RPJ105 — memory-budget regression
# --------------------------------------------------------------------------

def _mem_spec():
    return StepSpec(name="mem", fn=lambda x: (x @ x.T).sum(), args=(torch.zeros(64, 64),))


def test_rpj105_seeded_over_budget_and_unbudgeted():
    zero = Budgets(steps={"mem": {"temp_size_in_bytes": 0, "argument_size_in_bytes": 0,
                                  "output_size_in_bytes": 0}})
    found = _findings(_mem_spec(), zero, select=["RPJ105"])
    assert found and all(f.rule == "RPJ105" for f in found)
    assert any("exceeds budget" in f.message for f in found)
    found = _findings(_mem_spec(), select=["RPJ105"])
    assert len(found) == 3 and all("no budget" in f.message for f in found)


def test_rpj105_clean_within_tolerance():
    rec = measure(trace(_mem_spec()))
    assert rec["temp_size_in_bytes"] == 64 * 64 * 4 + 4  # x @ x.T, then the sum
    assert rec["argument_size_in_bytes"] == 64 * 64 * 4 and rec["output_size_in_bytes"] == 4
    assert _findings(_mem_spec(), Budgets(steps={"mem": rec}), select=["RPJ105"]) == []


# --------------------------------------------------------------------------
# RPJ106 — collective-traffic budget
# --------------------------------------------------------------------------

class _FakeTraced:
    def __init__(self, name, collectives):
        self.name = name
        self.collectives = collectives


def test_rpj106_seeded_unbudgeted_and_over_budget():
    ts = _FakeTraced("sharded_step", {"all-reduce": 768, "broadcast": 16, "count": 3})
    found = RULES["RPJ106"]([ts], None, Budgets())
    assert found and "no collective_bytes budget" in found[0].message
    tight = Budgets(steps={"sharded_step": {"collective_bytes": 8}}, tolerance=0.0)
    found = RULES["RPJ106"]([ts], None, tight)
    assert found and "exceeds budget" in found[0].message and "784 B" in found[0].message


def test_rpj106_clean_within_budget_and_no_collectives():
    ts = _FakeTraced("sharded_step", {"all-reduce": 768, "broadcast": 16, "count": 3})
    ok = Budgets(steps={"sharded_step": {"collective_bytes": 784}})
    assert RULES["RPJ106"]([ts], None, ok) == []
    local = _FakeTraced("local", {"all-reduce": 0, "broadcast": 0, "count": 0})
    assert RULES["RPJ106"]([local], None, Budgets()) == []


def test_mesh_inventory_in_place_and_collectives():
    """The 1 x 2 inventory, rank 0 of a fake group: every step writes its
    half of the pool in place (104,448 B a rank, JAX's alias bytes), the
    decode step all-reduces 2 a layer + the embedding + the logits, and the
    checked-in mesh budgets keep it clean."""
    import torch.distributed as dist

    with serving_inventory(InventoryConfig(device="cpu", mesh="1x2")) as inv:
        steps = [trace(spec) for spec in inv.specs]
        findings = run_rules(steps, inv, load_budgets(REPO / "torchcheck_mesh.budgets"))
        n_layers = inv.cfg.n_layers
    assert not dist.is_initialized()  # the fake group is gone
    assert not findings, "\n".join(f.format() for f in findings)
    assert all(ts.memory["alias_size_in_bytes"] == 104448 for ts in steps)
    decode = next(ts for ts in steps if ts.name == "decode_step_reference")
    assert decode.collectives["count"] == 2 * n_layers + 2 == 6
    # rank 0's arguments exactly: its weight shards and half the pool, each
    # shard a storage of its own (a view would count the whole leaf)
    assert decode.memory["argument_size_in_bytes"] == 573394
    print(f"1 x 2 decode collective bytes: port {measure(decode)['collective_bytes']}, "
          f"JAX {JAX_MESH_DECODE_COLLECTIVE_BYTES}")


# --------------------------------------------------------------------------
# budgets file round-trip
# --------------------------------------------------------------------------

def test_budgets_round_trip(tmp_path):
    measured = {"decode_step": {"temp_size_in_bytes": 100, "max_gather_bytes": 42}}
    waivers = {"decode_step": {"RPJ103"}, "global": {"RPJ102"}}
    reasons = {"decode_step": {"RPJ103": "index widening"}}
    conversions = {"global": {("int32", "int64"): "index dtype"},
                   "install": {("none", "int64"): "arange"}}
    text = format_budgets(measured, tolerance=0.25, allowed_widest="float32",
                          waivers=waivers, reasons=reasons, conversions=conversions)
    p = tmp_path / "torchcheck.budgets"
    p.write_text(text, encoding="utf-8")
    b = load_budgets(p)
    assert b.steps == measured and b.tolerance == 0.25
    assert b.waived("RPJ103", "decode_step")
    assert b.waived("RPJ102", "anything")  # global waiver
    assert not b.waived("RPJ101", "decode_step")
    assert b.reasons["decode_step"]["RPJ103"] == "index widening"
    assert b.conversions == conversions
    assert b.conversion_allowed("decode_step", ("int32", "int64"))  # global
    assert b.conversion_allowed("install", ("none", "int64"))
    assert not b.conversion_allowed("decode_step", ("none", "int64"))
    assert b.allowed("decode_step", "temp_size_in_bytes", 125)
    assert not b.allowed("decode_step", "temp_size_in_bytes", 126)
    assert format_budgets(b.steps, tolerance=b.tolerance, waivers=b.waivers,
                          reasons=b.reasons, conversions=b.conversions) == text


@pytest.mark.parametrize("text", ["[s]\nwaive = RPJ999\n", "[s]\nwaive = RPR002 -- x\n",
                                  "[global]\nallowed_widest = float128\n",
                                  "[s]\nmax_gather_bytes = many\n", "key = 1\n",
                                  "[s]\nallow_conversion = int32->int64\n",
                                  "[s]\nallow_conversion = int32 to int64 -- x\n",
                                  "[s]\nallow_conversion = int32->float128 -- x\n"])
def test_budgets_rejects_malformed(tmp_path, text):
    p = tmp_path / "bad.budgets"
    p.write_text(text, encoding="utf-8")
    with pytest.raises(ValueError):
        load_budgets(p)


# --------------------------------------------------------------------------
# CLI exit codes
# --------------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    assert main(["--list-rules"]) == 0
    capsys.readouterr()

    # clean run on the CPU against the checked-in budgets, with a report
    report_path = tmp_path / "torchcheck.json"
    rc = main(["--device", "cpu", "--budgets", str(REPO / "torchcheck.budgets"),
               "--json-out", str(report_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "decode_step: left out on cpu" in out and "cow_copy: left out on cpu" in out
    report = json.loads(report_path.read_text(encoding="utf-8"))
    assert report["status"] == "clean" and report["findings"] == []
    assert sorted(report["left_out"]) == ["cow_copy", "decode_step"]
    assert report["n_steps"] == len(report["steps"]) == 7

    # seeded regression: zeroed budgets must fail with findings
    bad = tmp_path / "bad.budgets"
    bad.write_text("[global]\ntolerance = 0.0\n\n[decode_step_reference]\n"
                   "temp_size_in_bytes = 1\nmax_gather_bytes = 1\n", encoding="utf-8")
    rc = main(["--device", "cpu", "--budgets", str(bad), "--select", "RPJ102", "RPJ105"])
    out = capsys.readouterr().out
    assert rc == 1 and "RPJ102" in out and "RPJ105" in out

    # a malformed budgets file is a usage error, before anything runs
    bad.write_text("[s]\nwaive = RPJ999\n", encoding="utf-8")
    assert main(["--device", "cpu", "--budgets", str(bad)]) == 2


def test_cli_write_budgets_reproduces_the_checked_in_file(tmp_path, capsys):
    """Re-measuring on the CPU rewrites ``torchcheck.budgets`` byte for
    byte: the CPU's sections measure the same, the card's sections
    (``decode_step``, ``cow_copy``) and every waiver with its reason are
    kept."""
    copy = tmp_path / "torchcheck.budgets"
    shutil.copy(REPO / "torchcheck.budgets", copy)
    assert main(["--device", "cpu", "--budgets", str(copy), "--write-budgets"]) == 0
    assert "2 kept" in capsys.readouterr().out
    assert copy.read_text() == (REPO / "torchcheck.budgets").read_text()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_inventory(InventoryConfig())
