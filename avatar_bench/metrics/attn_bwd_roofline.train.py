"""attn_bwd_roofline.train: the bound of the traced step's attention
backwards (self-attention, text and image cross-attention: 2.5 times the
forward's operations, q, k, v, o and dO read and dq, dk, dv written) over
the device time of the attention backward kernels: K4 and every SDPA
backward back end.  Moves train_step_s."""

import re

from avatar_bench.roofline_train import attn_bwd_bound_s

ATTENTION = re.compile(r"flash_fwd|flash_bwd|fmha|sdpa|attention|dual_context", re.I)
BACKWARD = re.compile(r"bwd|bprop|backward|cutlassB", re.I)


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("train"):
        return None
    seconds = sum(e - s for n, s, e in t.kernels if ATTENTION.search(n) and BACKWARD.search(n))
    if seconds <= 0:
        return None
    return 100.0 * attn_bwd_bound_s(ctx["calls"]) * t.steps / seconds
