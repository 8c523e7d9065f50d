"""Share of the device's busy time spent outside the stencil kernels: the
engine's layout round, the resets, the source injection and the receiver
copies (PyTorch's kernels, copies and memsets)."""
from portbench.metrics.timeline import union_us


def read(ctx):
    if ctx.trace is None:
        return None
    ops = ctx.trace.in_window()
    busy = union_us((o.start, o.end) for o in ops)
    if busy <= 0:
        return None
    return 100.0 * union_us((o.start, o.end) for o in ops if not o.stencil) / busy
