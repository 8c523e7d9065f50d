"""The device's idle time split over the host spans that cover it, instant
by instant.

``timeline.breakdown`` charges each whole idle gap to the span open as the
gap began.  A gap that opens after the source's injection and lasts
through the next ``st.map``'s dispatch is then all the injection's.  Here
every gap is cut at each span boundary inside it, and each piece goes to
the innermost span open through it (the spans nest, as ``record_function``
ranges on one thread do).  The program's own spans (``rt.*``: its
dispatch, sync, engine and source injection) make the split fine; a trace
that holds none of them (a program that opens none) gives no reading, and
so do the readers.

Host spans and device gaps meet instant by instant here, so the two clocks
must agree through the window, not only on average.  On the card they
drift apart in some traced windows, linearly: the fastest launch-to-start
gap of each quarter second rose from -311 to +53 µs across one 3 s window
(≈ 120 ppm), while others hold within a few µs.  ``Trace.from_rows``
removes one constant offset; ``aligned`` also takes out the drift, by the
lower convex hull of (device start, start - launch) over every launched
operation: a device time moves by the hull's height there, so each
operation launched on an idle card starts at its launch, as the constant
offset makes the fastest one do, and none starts before its launch.  The
hull's end segments steeper than ``MAX_DRIFT`` are operations queued
behind others (the last solve's launches, made ahead of the card), not
drift: they are cut, and the offset holds beyond the last vertex."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from portbench.metrics.timeline import Trace, idle_gaps

PROGRAM = "rt."
# ten times the largest drift seen between the clocks (≈ 120 ppm)
MAX_DRIFT = 1e-3


def _lower_hull(points: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The lower convex hull of ``points`` sorted by x (monotone chain)."""
    hull: List[Tuple[float, float]] = []
    for x, y in points:
        if hull and hull[-1][0] == x:       # the lowest of equal x came first
            continue
        while len(hull) >= 2 and ((hull[-1][0] - hull[-2][0]) * (y - hull[-2][1])
                                  - (hull[-1][1] - hull[-2][1]) * (x - hull[-2][0])) <= 0:
            hull.pop()
        hull.append((x, y))
    return hull


def aligned(trace: Trace) -> Trace:
    """``trace`` with the device's times moved onto the host's clock through
    the window: each device time less the launch-gap hull's height there
    (a monotone warp, so the operations keep their order and overlaps)."""
    hull = _lower_hull(sorted((o.start, o.start - o.launch) for o in trace.ops
                              if o.launch is not None))
    slope = lambda a, b: (b[1] - a[1]) / (b[0] - a[0])  # noqa: E731
    while len(hull) >= 2 and slope(hull[-2], hull[-1]) > MAX_DRIFT:
        hull.pop()
    while len(hull) >= 2 and slope(hull[0], hull[1]) < -MAX_DRIFT:
        hull.pop(0)
    if len(hull) < 2:
        return trace
    xs, ys = (np.asarray(v, dtype=np.float64) for v in zip(*hull))
    starts = np.asarray([o.start for o in trace.ops], dtype=np.float64)
    ends = np.asarray([o.end for o in trace.ops], dtype=np.float64)
    starts -= np.interp(starts, xs, ys)
    ends -= np.interp(ends, xs, ys)
    ops = [dataclasses.replace(o, start=float(a), end=float(b))
           for o, a, b in zip(trace.ops, starts, ends)]
    return dataclasses.replace(trace, ops=ops)


def segments(trace: Trace) -> List[Tuple[float, float, Optional[str]]]:
    """The window cut into ``(start, end, name)`` pieces, ``name`` the
    innermost span open through the piece (None: none but the window)."""
    a, b = trace.window
    spans = sorted((s for s in trace.spans if s.name != "window"),
                   key=lambda s: (s.start, -s.end))
    out, stack, t = [], [], a

    def upto(end):
        nonlocal t
        end = min(end, b)
        if end > t:
            out.append((t, end, stack[-1].name if stack else None))
            t = end

    for s in spans:
        while stack and stack[-1].end <= s.start:
            upto(stack[-1].end)
            stack.pop()
        upto(s.start)
        stack.append(s)
    while stack:
        upto(stack[-1].end)
        stack.pop()
    upto(b)
    return out


def idle_by_span(trace: Trace) -> Dict[Optional[str], float]:
    """Idle microseconds of the window (on ``aligned``'s clock) by the
    innermost host span that covers them (None: no span but the window)."""
    out: Dict[Optional[str], float] = {}
    segs = segments(trace)
    i = 0
    for ga, gb in idle_gaps(aligned(trace)):
        while i < len(segs) and segs[i][1] <= ga:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < gb:
            sa, sb, name = segs[j]
            d = min(sb, gb) - max(sa, ga)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            j += 1
    return out


def idle_pct(ctx, charged: Callable[[str], bool]) -> Optional[float]:
    """Share of the traced window in which the device is idle while the
    innermost host span is one that ``charged`` accepts; None without a
    trace or without any of the program's spans in it."""
    tr = ctx.trace
    if tr is None or tr.span_us <= 0 or not any(
            s.name.startswith(PROGRAM) for s in tr.spans):
        return None
    idle = idle_by_span(tr)
    return 100.0 * sum(v for n, v in idle.items() if n is not None and charged(n)) / tr.span_us
