"""Mean time, in microseconds, from the benchmark's ``st.map`` span
entering the call to the host's launch of that call's stencil kernel (the
DSL's binding, cache look-up and plan, host clock only), over the
``st.map`` calls of the traced window."""
from portbench.metrics.timeline import first_start_within


def read(ctx):
    if ctx.trace is None:
        return None
    launches = sorted(o.launch for o in ctx.trace.in_window()
                      if o.stencil and o.launch is not None)
    waits = []
    for s in ctx.trace.named_spans("st.map"):
        k = first_start_within(launches, s)
        if k is not None:
            waits.append(k - s.start)
    return sum(waits) / len(waits) if waits else None
