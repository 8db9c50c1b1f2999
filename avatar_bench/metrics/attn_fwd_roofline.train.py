"""attn_fwd_roofline.train: the bound of the traced step's attention
forwards (self-attention, text and image cross-attention from their
shapes, each run twice: the forward and remat's recompute; the larger of
operations over 989 TFLOP/s and bytes over 3.35 TB/s) over the device
time of the attention kernels that are not backward kernels: K1 in its
LSE form and every SDPA forward back end.  The per-frame vocal attention
is left out of the work; its kernels count in whichever class their names
fall.  Moves train_step_s."""

import re

from avatar_bench.roofline_train import attn_fwd_bound_s

ATTENTION = re.compile(r"flash_fwd|flash_bwd|fmha|sdpa|attention|dual_context", re.I)
BACKWARD = re.compile(r"bwd|bprop|backward|cutlassB", re.I)


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("train"):
        return None
    seconds = t.seconds(ATTENTION, exclude=BACKWARD)
    if seconds <= 0:
        return None
    return 100.0 * attn_fwd_bound_s(ctx["calls"]) * t.steps / seconds
