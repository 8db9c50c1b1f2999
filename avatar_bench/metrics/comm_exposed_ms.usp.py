"""comm_exposed_ms.usp: rank 0's milliseconds a window-step in which an
NCCL kernel (the exchanges, the gather of the token slices) ran on its
card and no other operation did, in the traced sweep.  Moves
window_step_s."""

from avatar_bench.roofline_usp import exposed_s, nccl


def read(ctx):
    t, usp = ctx.get("trace"), ctx.get("usp")
    if t is None or usp is None or not nccl(t.device):
        return None
    return 1e3 * exposed_s(t.device) / t.steps
