"""Share of the traced window in which the device is idle while the host
is in ``st.map``'s dispatch: innermost ``rt.map`` (its self time: bind,
cache key), ``rt.map.launch`` (plan arguments, library, launch call) or
``rt.build`` (a cache miss's lowering)."""
from portbench.metrics.host_layers import idle_pct

SPANS = frozenset({"rt.map", "rt.map.launch", "rt.build"})


def read(ctx):
    return idle_pct(ctx, SPANS.__contains__)
