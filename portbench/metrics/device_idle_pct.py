"""Share of the traced window in which no kernel, copy or memset ran on
the device: 1 - union of their intervals / the window's span, both from
the same trace."""


def read(ctx):
    if ctx.trace is None or ctx.trace.span_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.span_us)
