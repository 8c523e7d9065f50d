"""Share of the traced window in which the device is idle while the host
is in ``st.map``'s wait for the device (innermost ``rt.map.sync``): the
host's wake-up after the kernel ends."""
from portbench.metrics.host_layers import idle_pct


def read(ctx):
    return idle_pct(ctx, "rt.map.sync".__eq__)
