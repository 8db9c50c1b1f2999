"""gemm_roofline.train: the bound of the traced step's linear products
(every linear of the DiT from its shapes: its forward, remat's recompute
inside the blocks, the input's gradient where one flows and the weight's
gradient) over the device time of the matrix-multiply kernels (cuBLAS,
cuBLASLt, CUTLASS, GEMV), attention and convolution kernels excepted.
Moves train_step_s."""

import re

from avatar_bench.roofline_train import gemm_bound_s

GEMM = re.compile(r"gemm|gemv|cutlass|xmma|nvjet|cublas|splitK", re.I)
NOT_GEMM = re.compile(r"flash_fwd|flash_bwd|fmha|sdpa|attention|dual_context|conv|implicit_gemm|"
                      r"fprop|dgrad|wgrad|winograd", re.I)


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("train"):
        return None
    seconds = t.seconds(GEMM, exclude=NOT_GEMM)
    if seconds <= 0:
        return None
    return 100.0 * gemm_bound_s(ctx["calls"]) * t.steps / seconds
