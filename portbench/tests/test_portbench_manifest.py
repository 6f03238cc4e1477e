"""BENCHMARK.json against the benchmark's contract, and every file a cell,
a configuration or a metric needs found by its name."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.HERE)
MAN = harness.manifest(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
END_TO_END = {m["name"] for m in MAN["end_to_end"]}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    per_layer = metric["name"] not in END_TO_END
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if per_layer:
        assert metric["moves"] in END_TO_END
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert os.path.exists(os.path.join(harness.HERE, "metrics", metric["name"] + ".py"))
        assert callable(harness.reader(metric["name"]).read)
        moved = next(m for m in MAN["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    if metric["unit"] == "%" and "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline_pct")


@pytest.mark.parametrize("workload", MAN["workloads"], ids=lambda w: w["name"])
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_is_found_by_name(workload, trace):
    cell = harness.cell(MAN, workload["name"], 1, 1.0, trace)
    assert set(workload) == {"name", "config", "traffic", "chips", "why"}
    assert workload["chips"] == 1 and len(workload["why"]) <= 200
    assert cell.cfg["entry"] in ("pose_pipeline", "superglue_pairs")
    names = {m["name"] for m in cell.metrics}
    if trace:
        assert names  # at least one per-layer metric
    else:
        assert "setup_s" in names and len(names) >= 2
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_configs(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, conf["file"]))
    assert conf["source"].startswith("https://")
    assert any(w["config"] == conf["name"] for w in MAN["workloads"])
    assert len(conf["reduced"]) <= 16


def test_budget_fits_with_24_cells():
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.cell(MAN, "no_such_cell", 1, 1.0, False)
