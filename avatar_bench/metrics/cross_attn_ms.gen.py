"""cross_attn_ms.gen: device milliseconds a window-step of the program's
"sa.cross_attn" spans (`models/dit.py:apply_block` around
`_cross_attention`: text, image and per-frame vocal attention with their
projections), from their CUDA events in the traced sweep.  Moves
window_step_s."""

from avatar_bench.spans import own_ms


def read(ctx):
    return own_ms(ctx, "sa.cross_attn", ())
