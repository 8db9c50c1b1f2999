"""Run one cell of the benchmark once and print its result line.

    python3 -m avatar_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the NVIDIA cards the cell
asks for.  Set-up (imports, the kernel library, weights made from the seed,
conditioning, the warm-up) counts from the start of this module; then the
cell's traffic runs for `--seconds`, its outputs are compared with the
plain reference, and the last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `compared`: each compared number beside its limit
(also the last lines of standard error).  No card, too few cards, or a
JAX module loaded: a message on standard error, no result, exit code 2.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from avatar_bench import core  # noqa: E402

CACHE = core.ROOT / ".bench_cache"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m avatar_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"avatar_bench: {msg}", file=sys.stderr, flush=True)
    return 2


def power_limit_w():
    """The card's power limit as nvidia-smi reports it (a card set below its
    700 W runs slower under load), or None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "--id=0"], capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = core.load_cell(args.workload)
    except core.BenchError as e:
        return fail(str(e))
    # kernel caches at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA card: torch.cuda.is_available() is false; the benchmark runs "
                    "only on the card")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} cards, this machine has "
                    f"{torch.cuda.device_count()}")
    kind = core.traffic_module(cell.traffic["kind"])
    out = kind.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   t0=T0, device="cuda")
    bad = core.forbidden_modules()
    if bad:
        return fail(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes), "power_limit_w": power_limit_w()}
    line = core.result_line(cell, out, bool(args.trace), device)
    for c in out.checks:
        print(f"compared {c.name} = {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
