"""idle_in_dit_ms.gen: milliseconds a window-step in which the card ran
nothing while the host was inside the program's "sa.dit" span: the gaps in
the union of the device's operations within the traced "sa.denoise_step"
span (extended to the sweep's last device operation), the part of each
that overlaps an "sa.dit" host range.  Moves window_step_s."""

from avatar_bench.spans import idle_split


def read(ctx):
    got = idle_split(ctx)
    return None if got is None else got[0]
