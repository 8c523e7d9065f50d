"""A traced window in the form the per-layer readers take, and the interval
arithmetic they share.

``Trace.from_profiler`` reads a ``torch.profiler`` run: the device's
operations (kernels, copies, memsets) and the benchmark's own
``record_function`` spans, all on the profiler's one clock, in
microseconds.  The window is the benchmark's ``window`` span, so busy time
and span come from the same trace.

Stencil kernels are the device kernels that are not PyTorch's own (ATen,
cub, thrust) and not copies or memsets: the program's hand-written kernels,
whatever they are named.  Everything else on the device is auxiliary work
(layout copies, resets, hooks).

The device's and the host's timelines of one trace need not agree: three
traced runs of one build read 222, 818 and 565 µs, on average, from an
``st.map`` span's start to its kernel's start on the device, a spread the
host's own work does not show.  So each operation keeps the host time of
the call that launched it (kernel, copy or memset), readers that measure
host work use those, and the device's times are shifted so that the
fastest launch-to-start gap is 0: every solve begins with the card idle,
so that gap is a launch's latency, a few microseconds.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LIBRARY_MARKS = ("at::", "cub::", "thrust::")


@dataclasses.dataclass(frozen=True)
class Op:
    """One device operation: ``kind`` is ``kernel``, ``gpu_memcpy`` or
    ``gpu_memset``; times in microseconds."""
    name: str
    kind: str
    start: float
    end: float
    launch: Optional[float] = None     # host time of the launching call

    @property
    def stencil(self) -> bool:
        """A hand-written kernel of the program."""
        return self.kind == "kernel" and not any(m in self.name for m in LIBRARY_MARKS)


@dataclasses.dataclass(frozen=True)
class Span:
    """One of the benchmark's host spans (``record_function``)."""
    name: str
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    ops: List[Op]
    spans: List[Span]
    window: Interval
    offset_us: float = 0.0          # the shift applied to the device's times

    @property
    def span_us(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self) -> List[Op]:
        """The device operations that overlap the window, clipped to it."""
        a, b = self.window
        return [dataclasses.replace(o, start=max(o.start, a), end=min(o.end, b))
                for o in self.ops if o.end > a and o.start < b]

    def busy_us(self) -> float:
        return union_us((o.start, o.end) for o in self.in_window())

    def named_spans(self, name: str) -> List[Span]:
        a, b = self.window
        return [s for s in self.spans if s.name == name and s.start >= a and s.end <= b]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """Read a finished ``torch.profiler.profile`` from its Chrome trace
        (written to a temporary file and removed): the events' kinds and
        the correlation of each launch with its kernel, in every PyTorch
        since 2.0."""
        return cls.from_rows(_chrome_rows(prof))

    @classmethod
    def from_rows(cls, rows, window_name: str = "window") -> "Trace":
        """From ``(kind, name, start, end, correlation)`` rows in the Chrome
        trace's categories, the device's times aligned to the launches."""
        ops, spans, launches = [], [], {}
        for kind, name, start, end, corr in rows:
            if kind in DEVICE_KINDS:
                ops.append((name, kind, start, end, corr))
            elif kind == "user_annotation":
                spans.append(Span(name, start, end))
            elif kind in ("cuda_runtime", "cuda_driver") and any(
                    m in name for m in ("Launch", "Memcpy", "Memset")):
                launches[corr] = start
        gaps = [s - launches[c] for _, _, s, _, c in ops if c in launches]
        offset = min(gaps) if gaps else 0.0
        ops = [Op(n, k, s - offset, e - offset, launches.get(c))
               for n, k, s, e, c in ops]
        wins = [s for s in spans if s.name == window_name]
        if len(wins) != 1:
            raise RuntimeError(f"the trace holds {len(wins)} '{window_name}' spans")
        ops.sort(key=lambda o: o.start)
        spans.sort(key=lambda s: s.start)
        return cls(ops, spans, (wins[0].start, wins[0].end), offset)


def _chrome_rows(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            start = float(e["ts"])
            yield (e.get("cat", ""), e["name"], start, start + float(e["dur"]),
                   e.get("args", {}).get("correlation"))


def union_us(spans: Iterable[Interval]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, None
    for a, b in sorted(spans):
        if reach is None or a > reach:
            total, reach = total + b - a, b
        elif b > reach:
            total, reach = total + b - reach, b
    return total


def merged(spans: Iterable[Interval]) -> List[Interval]:
    """The union of intervals as disjoint, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(trace: Trace) -> List[Interval]:
    """The window's stretches in which no device operation ran."""
    a, b = trace.window
    gaps, reach = [], a
    for s, e in merged((o.start, o.end) for o in trace.in_window()):
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if b > reach:
        gaps.append((reach, b))
    return gaps


def host_spans_at(trace: Trace, times: Sequence[float]) -> List[str]:
    """For each of ``times`` (sorted), the innermost benchmark span (other
    than the window) open then, in one sweep: the spans nest, as
    ``record_function`` ranges on one thread do."""
    spans = [s for s in trace.spans if s.name != "window"]
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end <= spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out.append(stack[-1].name if stack else "window")
    return out


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, summed by name, and the
    idle time summed by the host span open as each gap began, in seconds."""
    ops: Dict[str, float] = {}
    for o in trace.in_window():
        key = o.name[:120]
        ops[key] = ops.get(key, 0.0) + (o.end - o.start) / 1e6
    idle: Dict[str, float] = {}
    gaps = idle_gaps(trace)
    for (s, e), key in zip(gaps, host_spans_at(trace, [g[0] for g in gaps])):
        idle[key] = idle.get(key, 0.0) + (e - s) / 1e6
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def first_start_within(starts: Sequence[float], span: Span) -> Optional[float]:
    """The first of ``starts`` (sorted) that lies inside ``span``."""
    i = bisect.bisect_left(starts, span.start)
    if i < len(starts) and starts[i] <= span.end:
        return starts[i]
    return None
