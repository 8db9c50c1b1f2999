"""all_to_all_ms.usp: rank 0's device milliseconds a window-step in the
kernels of the Ulysses exchanges (`models/dit.py:_seq_to_heads`,
`_heads_to_seq` over `parallel/mesh.py:all_to_all_dim0`: NCCL's grouped
send and receive, found by name), in the traced sweep.  A kernel's time
holds its wait for the slowest rank.  Moves window_step_s."""

from avatar_bench.roofline_usp import exchange_s


def read(ctx):
    t, usp = ctx.get("trace"), ctx.get("usp")
    if t is None or usp is None:
        return None
    s = exchange_s(t.device)
    return 1e3 * s / t.steps if s > 0 else None
