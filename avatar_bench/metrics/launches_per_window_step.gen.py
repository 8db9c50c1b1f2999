"""launches_per_window_step.gen: kernels launched on the card a window-step
in the traced sweep (copies and fills left out): the dispatch cost of
`pipelines/long.py:_sweep_step` -> `dit_forward`.  Moves window_step_s."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx.get("train") or not t.kernels:
        return None
    return len(t.kernels) / t.steps
