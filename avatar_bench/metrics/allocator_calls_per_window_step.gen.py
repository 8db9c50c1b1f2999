"""allocator_calls_per_window_step.gen: the caching allocator's calls into
CUDA (cudaMalloc and cudaFree, `torch.cuda.memory_stats()`
num_device_alloc + num_device_free) inside the traced "sa.denoise_step"
span, over the window-steps in it.  Moves window_step_s."""

from avatar_bench.spans import allocator_calls


def read(ctx):
    return allocator_calls(ctx)
