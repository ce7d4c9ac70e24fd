"""% of the traced window in which no kernel or copy ran on the device:
one minus the union of the device events' intervals over the window."""

from portbench.trace import union_ns


def read(ctx):
    if not ctx.spans:
        return None
    return 100.0 * (1.0 - union_ns(ctx.spans) / 1e9 / ctx.window_s)
