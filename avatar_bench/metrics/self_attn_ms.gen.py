"""self_attn_ms.gen: device milliseconds a window-step of the program's
"sa.self_attn" spans (`models/dit.py:apply_block` around
`_self_attention`: projections, q / k norms, rope, K1, output), from their
CUDA events in the traced sweep.  Moves window_step_s."""

from avatar_bench.spans import own_ms


def read(ctx):
    return own_ms(ctx, "sa.self_attn", ())
