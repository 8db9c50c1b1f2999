"""encode_ms.train: device milliseconds a train step of the kernels, copies
and fills launched inside `train/loop.py:encode_batch` (the batch's host
to device copies, the VAE encodes of the clip and the masked clip, CLIP on
the reference image, wav2vec2 on the audio, the mask resizes): the host
ranges "bench.encode" that the traced run opens around that call, each
device operation matched to its launch by the profiler's correlation id.
Moves train_step_s."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("train") or not hasattr(t, "launched_s"):
        return None
    seconds = t.launched_s("bench.encode")
    return 1e3 * seconds / t.steps if seconds > 0 else None
