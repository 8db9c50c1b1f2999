"""elementwise_ms.train: device milliseconds a train step of the kernels in
no attention, matrix-multiply or convolution class (the DiT's norms,
modulation, GELU, rope and cast chains forward and backward, the loss,
the encoders' norms and activations, the optimizer's elementwise passes),
copies and fills left out.  Moves train_step_s."""

import re

CLASSED = re.compile(r"flash_fwd|flash_bwd|fmha|sdpa|attention|dual_context|gemm|gemv|cutlass|"
                     r"xmma|nvjet|cublas|splitK|conv|fprop|dgrad|wgrad|winograd", re.I)


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx.get("train") or not t.kernels:
        return None
    return 1e3 * sum(e - s for n, s, e in t.kernels if not CLASSED.search(n)) / t.steps
