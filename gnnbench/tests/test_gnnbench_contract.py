"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its file."""

import json
import re

import pytest

from gnnbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gnnbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]] + CELLS
                         + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    e2e = metric in BENCH["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if e2e else {"layer", "moves"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert metric["source"] in (("host_clock", "device_trace") if e2e else
                                ("device_trace", "program_span", "program_counter",
                                 "host_clock"))
    if e2e:
        assert 0.01 <= metric["bound"] <= 0.25
    assert core.reader(metric["name"]).read is not None


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = core.cell(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cfg = core.load_yaml(core.config_file(BENCH, w["config"]))
    assert cfg["name"] == w["config"]
    mix = core.load_yaml(core.traffic_file(w["traffic"]))
    assert callable(core.entry(mix["entry"]).build)
    limits = json.loads(core.limits_file(cell).read_text())["limits"]
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    """setup_s, another end-to-end metric and a per-layer one; and every
    per-layer metric of the cell moves an end-to-end metric it reports."""
    e2e = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], cell)


def test_configs_used_and_files_apart():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(set(files)) == len(files) and all(f.startswith("gnnbench/") for f in files)
    for c in BENCH["configs"]:
        assert len(c["source"]) <= 200 and c["reduced"] == []


def test_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
