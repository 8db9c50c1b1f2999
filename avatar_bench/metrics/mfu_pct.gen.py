"""mfu_pct.gen: the traced sweep's model operations (every linear and
attention product of the DiT's forward, from the configuration and the
shapes: `roofline.dit_calls`) over its wall time, as a share of the card's
dense bf16 peak (989 TFLOP/s, H100 SXM at 700 W).  Moves window_step_s."""

from avatar_bench.roofline import PEAK_BF16, model_flops


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx.get("train") or t.window_s <= 0:
        return None
    return 100.0 * model_flops(ctx["calls"]) * t.steps / (t.window_s * PEAK_BF16)
