"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re
import shutil

import pytest

from avatar_bench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return core.benchmark()


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert not any(p.endswith("_torch") for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(one_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits in 43,200 s
    cells = 24
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = core.read_json(core.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    names = list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and core.reports(e2e[m["moves"]], cell, ())
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in list(e2e.values()) + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:
        mine = [m for m in bench["end_to_end"] if core.reports(m, cell, ())]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(core.reports(m, cell, {x["name"] for x in mine}) for m in bench["per_layer"])


def test_every_file_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell = core.load_cell(w["name"])
        kind = core.traffic_module(cell.traffic["kind"])
        assert callable(kind.run)
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        for m in cell.per_layer:
            assert callable(core.metric_reader(m["name"]))


def test_a_dropped_in_metric_is_read(tmp_path):
    """A later PR adds a per-layer metric as one file under metrics/ and one
    entry: nothing else changes.  A reader that finds nothing is left out."""
    metrics = tmp_path / "metrics"
    shutil.copytree(core.PACKAGE / "metrics", metrics)
    (metrics / "dummy_ms.gen.py").write_text("def read(ctx):\n    return 7.5\n")
    (metrics / "silent_ms.gen.py").write_text("def read(ctx):\n    return None\n")
    cell = core.load_cell("gen-1.3b-euler")
    cell.per_layer = cell.per_layer + [
        {"name": "dummy_ms.gen", "unit": "ms"}, {"name": "silent_ms.gen", "unit": "ms"}]
    got = core.read_per_layer(cell, {"trace": None, "calls": [], "steps": 1}, metrics)
    assert got == {"dummy_ms.gen": {"value": 7.5, "unit": "ms"}}
