"""BENCHMARK.json against the contract's shape, every cell's files found by
name, and the import guard over the benchmark's modules."""

import ast
import glob
import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.read_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = harness.resolve(workload, BENCH)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell.cell["config"])
    assert entry["file"].startswith("portbench/configs/")
    assert cell.config["name"] == entry["name"]
    assert set(cell.config["reduced"]) == set(entry["reduced"])
    assert hasattr(harness.load("tools", cell.config["tool"]), "Driver")
    assert set(cell.config["limits"])
    for m in cell.per_layer:
        assert callable(harness.load("metrics", m["name"]).read)
    # the cell reports setup_s, another end-to-end metric, and a per-layer one
    assert {"setup_s", "mbp_per_s"} <= {m["name"] for m in cell.end_to_end}
    assert cell.per_layer


def test_bbduk_reference_parameters_are_the_flags():
    cfg = harness.read_json(ROOT, "portbench/configs/bbduk_adapter_trim.json")
    r, flags = cfg["reference"], set(cfg["flags"])
    assert {f"k={r['k']}", f"mink={r['mink']}", f"hdist={r['hdist']}", "ktrim=r"} <= flags
    assert ("tpe" in flags) == r["tpe"] and ("tbo" in flags) == r["tbo"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                                               recursive=True)))
def test_import_guard(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "bbtools_tpu"}, tops
    if os.sep + "reference" + os.sep in path:
        assert "bbtools_torch" not in tops and "portbench" not in tops, tops
