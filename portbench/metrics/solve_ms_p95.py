"""95th percentile, in milliseconds, of every solve completed in the
window: from the start of its reset to its final sync, read from CUDA
events the benchmark records around it (the device's clock; a solve is
shorter than the host clock's 250 ms floor).  Needs 20 solves or more."""
import statistics


def read(ctx):
    xs = ctx.solve_s
    if len(xs) < 20:
        return None
    return statistics.quantiles(xs, n=100, method="inclusive")[94] * 1e3
