"""mfu_pct.train: the traced train step's model operations (the DiT's
forward and backward, three times the forward's linear and attention
products of `roofline.dit_calls` at one row; remat's recompute not
counted) over its wall time, as a share of the card's dense bf16 peak
(989 TFLOP/s, H100 SXM at 700 W).  Moves train_step_s."""

from avatar_bench.roofline import PEAK_BF16
from avatar_bench.roofline_train import step_flops


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("train") or t.window_s <= 0:
        return None
    return 100.0 * step_flops(ctx["calls"]) * t.steps / (t.window_s * PEAK_BF16)
