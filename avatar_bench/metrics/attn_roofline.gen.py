"""attn_roofline.gen: the bound of the traced sweep's attention calls
(self-attention, text and image cross-attention, from their shapes: the
larger of operations over 989 TFLOP/s and bytes over 3.35 TB/s, each
input read once and each output written once) over the device time of
the kernels that compute attention: the port's flash kernels (K1 and its
LSE form, K4, K5) and every SDPA back end PyTorch can pick on sm_90
(flash, memory-efficient, cuDNN).  The per-frame vocal attention is left
out of the work; its kernels count in whichever class their names fall.
Moves window_step_s."""

import re

from avatar_bench.roofline import bound_s

ATTENTION = re.compile(r"flash_fwd|flash_bwd|fmha|sdpa|attention|dual_context", re.I)


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx.get("train"):
        return None
    seconds = t.seconds(ATTENTION)
    if seconds <= 0:
        return None
    return 100.0 * bound_s(ctx["calls"], "attention") * t.steps / seconds
