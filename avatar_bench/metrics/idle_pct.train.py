"""idle_pct.train: the share of the traced train step's wall time in which
no kernel, copy or fill ran on the card: 1 - (union of their intervals) /
wall.  Moves train_step_s."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("train") or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
