"""What every run shares: finding a cell's files by name, the run's context,
the compared numbers with their limits, and the per-layer metric readers.

A cell (`BENCHMARK.json` "workloads") names a configuration and a traffic
mix.  Their data live in files of their own, found by name:

- `configs/<config>.json`: the model's sizes and dtypes;
- `traffic/<traffic>.json`: the mix's parameters, with its "kind", the
  module `traffic/<kind>.py` that generates and runs it;
- `workloads/<cell>.json`: the cell's correctness limits and the readings
  they were set from;
- `metrics/<metric>.py`: a per-layer metric's reader, `read(ctx)`, which
  returns a number or None when it finds nothing to read.

A later cell, mix or metric is a new file and an entry in `BENCHMARK.json`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "stableavatar_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result: the message says why."""


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing file {path}")
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # workloads/<cell>.json "limits"
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a metric belongs to a cell: listed there, or, with no list,
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    w = _named(bench["workloads"], name, "workload")
    c = _named(bench["configs"], w["config"], "configuration")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=read_json(root / c["file"]),
                traffic=read_json(PACKAGE / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(PACKAGE / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer)


def traffic_module(kind: str):
    return importlib.import_module(f"avatar_bench.traffic.{kind}")


def metric_reader(name: str, directory: Path = PACKAGE / "metrics"):
    """The `read` function of metrics/<name>.py (names may hold dots)."""
    path = directory / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader {path} for the per-layer metric {name}")
    spec = importlib.util.spec_from_file_location(f"avatar_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, ctx, directory: Path = PACKAGE / "metrics") -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], directory)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


@dataclasses.dataclass
class Check:
    """One compared number: correct while finite and at most `limit`."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def forbidden_modules(modules=None) -> List[str]:
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Outcome:
    """What a traffic kind hands back to the harness after its window."""

    metrics: Dict[str, float]  # end-to-end values by name
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None  # a trace.Trace of the traced run
    layer_ctx: Any = None  # what the per-layer readers read

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def result_line(cell: Cell, out: Outcome, traced: bool, device: Dict[str, Any]) -> dict:
    """The run's last line of standard output."""
    if traced:
        metrics = read_per_layer(cell, out.layer_ctx)
    else:
        metrics = {m["name"]: {"value": float(out.metrics[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out.metrics}
    line: Dict[str, Any] = {"correct": out.correct, "attempted": out.attempted,
                            "failed": out.failed, "metrics": metrics, "device": device}
    if traced and out.trace is not None:
        line["device"] = dict(device, busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        line["breakdown"] = out.trace.breakdown()
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line
