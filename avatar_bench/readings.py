"""Readings that set a cell's correctness limits, in one process.

    python3 -m avatar_bench.readings --workload <cell> --seeds 1,2,3 \
        --variants program,control,fault:unchanged [--seconds 0]

For each variant and seed, one run of the cell with a window of `seconds`
(0: just long enough to hold the checked sweep), printing one JSON line
with the compared numbers.  "program" is the cell as the benchmark runs
it; "control" is the program's lower-precision path in its place (see the
traffic kind's `run`); "fault:<name>" plants a fault of the kind's table
in `FAULTS` under the program.  A kind that runs workers (`run_jobs`, as
`gen_usp`) runs every reading on one set-up of its ranks and plants each
fault in every rank by name.  It needs the card; the benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from avatar_bench import core, faults, faults_train, faults_usp

# each traffic kind's table of faults, name -> context manager
FAULTS = {"gen": faults.GEN, "train": faults_train.TRAIN, "gen_usp": faults_usp.USP}


def fault_of(cell, variant: str):
    """(the fault's name or None, the variant the program runs as)."""
    if not variant.startswith("fault:"):
        return None, variant
    name, table = variant.split(":", 1)[1], FAULTS[cell.traffic["kind"]]
    if name not in table:
        raise SystemExit(f"no fault named {name!r}; one of {sorted(table)}")
    return name, "program"


def line(variant: str, seed: int, out, seconds: float) -> dict:
    return {"variant": variant, "seed": seed, "correct": out.correct,
            "compared": {c.name: c.value for c in out.checks},
            "metrics": out.metrics, "seconds": seconds}


def reading(cell, seed: int, variant: str, seconds: float, device: str = "cuda") -> dict:
    kind = core.traffic_module(cell.traffic["kind"])
    fault, run_variant = fault_of(cell, variant)
    planted = (contextlib.nullcontext() if fault is None
               else FAULTS[cell.traffic["kind"]][fault]())
    t0 = time.monotonic()
    with planted:
        out = kind.run(cell, seed=seed, seconds=seconds, trace=False, t0=t0, device=device,
                       variant=run_variant)
    return line(variant, seed, out, time.monotonic() - t0)


def worker_jobs(cell, kind, todo, seconds: float) -> list:
    """The `kind.Job` of each (variant, seed) in `todo`, its fault named."""
    jobs = []
    for variant, seed in todo:
        fault, run_variant = fault_of(cell, variant)
        jobs.append(kind.Job(seed, seconds, variant=run_variant, fault=fault))
    return jobs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m avatar_bench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program,control")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("avatar_bench.readings: no CUDA card", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    todo = [(v, int(s)) for v in args.variants.split(",") for s in args.seeds.split(",")]
    kind = core.traffic_module(cell.traffic["kind"])
    if hasattr(kind, "run_jobs"):
        t0 = time.monotonic()

        def report(job, out):
            nonlocal t0
            variant = f"fault:{job.fault}" if job.fault else job.variant
            print(json.dumps(line(variant, job.seed, out, time.monotonic() - t0)), flush=True)
            t0 = time.monotonic()

        kind.run_jobs(cell, worker_jobs(cell, kind, todo, args.seconds), t0, on_outcome=report)
        return 0
    for variant, seed in todo:
        print(json.dumps(reading(cell, seed, variant, args.seconds)), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
