"""optimizer_ms.train: device milliseconds a train step of the kernels,
copies and fills launched inside `train_step`'s optimizer part
(`optim.global_norm`, the chain's `update`, `optim.apply_updates`): the
host ranges "bench.optimizer" that the traced run opens around those
calls, each device operation matched to its launch by the profiler's
correlation id.  Moves train_step_s."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("train") or not hasattr(t, "launched_s"):
        return None
    seconds = t.launched_s("bench.optimizer")
    return 1e3 * seconds / t.steps if seconds > 0 else None
