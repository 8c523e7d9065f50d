"""Share of the traced window in which the device is idle while the host
is inside the program's launch of a solve: innermost ``rt.launch``,
``rt.timeloop``, ``rt.build`` or an ``rt.engine.*`` span other than
``rt.engine.sync`` (the host between a solve's reset and its first
kernel, and after its last window's sync returns)."""
from portbench.metrics.host_layers import idle_pct

SPANS = frozenset({"rt.launch", "rt.timeloop", "rt.build"})


def charged(name):
    return name in SPANS or (name.startswith("rt.engine.") and name != "rt.engine.sync")


def read(ctx):
    return idle_pct(ctx, charged)
