"""ffn_ms.gen: device milliseconds a window-step of the program's "sa.ffn"
spans (`models/dit.py:apply_block` around fc1, GELU, fc2), from their CUDA
events in the traced sweep.  Moves window_step_s."""

from avatar_bench.spans import own_ms


def read(ctx):
    return own_ms(ctx, "sa.ffn", ())
