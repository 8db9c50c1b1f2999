"""all_to_all_link_pct.usp: the bytes one card sends in a window-step's
exchanges (`roofline_usp.exchange_bytes`, from the configuration and the
shapes) over rank 0's device time in their kernels, as a share of NVLink
4's 450 GB/s in one direction on an H100 SXM.  Moves window_step_s."""

from avatar_bench.roofline_usp import NVLINK_BYTES_S, exchange_s


def read(ctx):
    t, usp = ctx.get("trace"), ctx.get("usp")
    if t is None or usp is None or not usp.get("exchange_bytes"):
        return None
    s = exchange_s(t.device)
    if s <= 0:
        return None
    return 100.0 * usp["exchange_bytes"] * t.steps / s / NVLINK_BYTES_S
