"""gemm_roofline.gen: the bound of the traced sweep's linears (every
F.linear of the DiT's forward, from its shapes: the larger of operations
over 989 TFLOP/s and bytes over 3.35 TB/s) over the device time of the
matrix-multiply kernels (cuBLAS, cuBLASLt, CUTLASS, GEMV), attention and
convolution kernels excepted.  The short-query vocal attention's batched
products fall in this class and their work is not counted.  Moves
window_step_s."""

import re

from avatar_bench.roofline import bound_s

GEMM = re.compile(r"gemm|gemv|cutlass|xmma|nvjet|cublas|splitK", re.I)
NOT_GEMM = re.compile(r"flash_fwd|flash_bwd|fmha|sdpa|attention|dual_context|conv|implicit_gemm|"
                      r"fprop|dgrad|wgrad|winograd", re.I)


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx.get("train"):
        return None
    seconds = t.seconds(GEMM, exclude=NOT_GEMM)
    if seconds <= 0:
        return None
    return 100.0 * bound_s(ctx["calls"], "linear") * t.steps / seconds
