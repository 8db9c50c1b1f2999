"""sweep_update_ms.gen: device milliseconds a window-step of the sweep's own
work around the DiT: "sa.window" less "sa.dit" (`pipelines/long.py:
_sweep_step`'s CFG tripling, guidance combine, Euler step, bf16 store,
blend and write-back), from the spans' CUDA events in the traced sweep.
Moves window_step_s."""

from avatar_bench.spans import own_ms


def read(ctx):
    return own_ms(ctx, "sa.window", ("sa.dit",))
