"""block_chain_ms.gen: device milliseconds a window-step of the DiT blocks
outside their three branches: "sa.block" less "sa.self_attn",
"sa.cross_attn" and "sa.ffn" (the modulation, the three layer norms, the
residual adds and the casts of `models/dit.py:apply_block`), from the
spans' CUDA events in the traced sweep.  Moves window_step_s."""

from avatar_bench.spans import own_ms


def read(ctx):
    return own_ms(ctx, "sa.block", ("sa.self_attn", "sa.cross_attn", "sa.ffn"))
