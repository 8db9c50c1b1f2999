"""idle_outside_dit_ms.gen: milliseconds a window-step in which the card ran
nothing while the host was outside the program's "sa.dit" spans (the
sweep's bookkeeping and update dispatch, the end-of-sweep synchronise):
the rest of the gaps that idle_in_dit_ms.gen splits.  Moves
window_step_s."""

from avatar_bench.spans import idle_split


def read(ctx):
    got = idle_split(ctx)
    return None if got is None else got[1]
