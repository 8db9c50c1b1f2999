"""launches_per_step.train: kernels launched on the card a train step in the
traced step (copies and fills left out): the dispatch cost of
`train/loop.py:train`'s encode and `train/trainer.py:train_step`.  Moves
train_step_s."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("train") or not t.kernels:
        return None
    return len(t.kernels) / t.steps
