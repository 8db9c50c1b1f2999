"""elementwise_ms.gen: device milliseconds a window-step of the kernels in
no attention, matrix-multiply or convolution class (the DiT's norms,
modulation, GELU, bias, rope and cast chains, the CFG combine and the
Euler update), copies and fills left out.  Moves window_step_s."""

import re

CLASSED = re.compile(r"flash_fwd|flash_bwd|fmha|sdpa|attention|dual_context|gemm|gemv|cutlass|"
                     r"xmma|nvjet|cublas|splitK|conv|fprop|dgrad|wgrad|winograd", re.I)


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx.get("train") or not t.kernels:
        return None
    return 1e3 * sum(e - s for n, s, e in t.kernels if not CLASSED.search(n)) / t.steps
