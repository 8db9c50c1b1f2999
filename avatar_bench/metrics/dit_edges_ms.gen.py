"""dit_edges_ms.gen: device milliseconds a window-step of the DiT outside
its block stack: "sa.dit" less "sa.block" (the prologue's patch embedding,
rope tables, time / text / image embeddings and vocal projector, the head
and the unpatchify), from the spans' CUDA events in the traced sweep.
Moves window_step_s."""

from avatar_bench.spans import own_ms


def read(ctx):
    return own_ms(ctx, "sa.dit", ("sa.block",))
