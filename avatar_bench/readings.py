"""Readings that set a cell's correctness limits, in one process.

    python3 -m avatar_bench.readings --workload <cell> --seeds 1,2,3 \
        --variants program,control,fault:unchanged [--seconds 0]

For each variant and seed, one run of the cell with a window of `seconds`
(0: just long enough to hold the checked sweep), printing one JSON line
with the compared numbers.  "program" is the cell as the benchmark runs
it; "control" is the program's lower-precision path in its place (see the
traffic kind's `run`); "fault:<name>" plants a fault of `faults.py` under
the program.  It needs the card; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from avatar_bench import core, faults, faults_train

# each traffic kind's table of faults, name -> context manager
FAULTS = {"gen": faults.GEN, "train": faults_train.TRAIN}


def reading(cell, seed: int, variant: str, seconds: float, device: str = "cuda") -> dict:
    kind = core.traffic_module(cell.traffic["kind"])
    planted = contextlib.nullcontext()
    run_variant = variant
    if variant.startswith("fault:"):
        table = FAULTS[cell.traffic["kind"]]
        planted, run_variant = table[variant.split(":", 1)[1]](), "program"
    t0 = time.monotonic()
    with planted:
        out = kind.run(cell, seed=seed, seconds=seconds, trace=False, t0=t0, device=device,
                       variant=run_variant)
    return {"variant": variant, "seed": seed, "correct": out.correct,
            "compared": {c.name: c.value for c in out.checks},
            "metrics": out.metrics, "seconds": time.monotonic() - t0}


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
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(reading(cell, seed, variant, args.seconds)), flush=True)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
