"""Share of the traced window in which the device is idle while the host
runs a step's hooks: innermost the program's ``rt.inject_source`` or the
benchmark's ``receivers`` (the receiver plane's copy)."""
from portbench.metrics.host_layers import idle_pct

SPANS = frozenset({"rt.inject_source", "receivers"})


def read(ctx):
    return idle_pct(ctx, SPANS.__contains__)
