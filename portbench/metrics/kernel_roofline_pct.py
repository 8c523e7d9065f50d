"""The stencil kernels' share of their roofline in the traced window: the
least time the card needs for the window's work (``yardstick``: the
expression's operations over the f32 peak, or the compulsory bytes of
every observable state over the memory peak, whichever is larger) over
the device time of the program's hand-written kernels in the trace."""
from portbench.metrics.yardstick import least_seconds


def read(ctx):
    if ctx.trace is None or ctx.steps <= 0:
        return None
    busy = sum(o.end - o.start for o in ctx.trace.in_window() if o.stencil) / 1e6
    if busy <= 0:
        return None
    least, _ = least_seconds(ctx.cfg, ctx.steps, ctx.boundaries, ctx.kind)
    return 100.0 * least / busy
