"""rank_busy_spread_pct.usp: (largest - smallest) / largest of the ranks'
busy seconds in the traced sweep, busy meaning an operation other than
NCCL's kernels running on the card (a rank that waits for the slowest
spins inside NCCL).  Moves window_step_s."""

from avatar_bench.roofline_usp import compute
from avatar_bench.trace import union_s


def read(ctx):
    usp = ctx.get("usp")
    if ctx.get("trace") is None or usp is None:
        return None
    busy = [union_s(compute(d)) for d in usp["ranks"]]
    if not busy or max(busy) <= 0:
        return None
    return 100.0 * (max(busy) - min(busy)) / max(busy)
