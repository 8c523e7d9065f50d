"""Host spans of the port: the one timer of the launch profile and of the
profiler's trace.

``with span(name, phase=None):`` marks a stretch of host work.

- Under ``st.launch`` a span with a ``phase`` adds its host seconds to the
  launch's profile (``LaunchResult.profile``) under that phase; the sink is
  this thread's innermost launch (``collect``), so a launch inside another
  (the autotuner's measurements) keeps its own profile.
- While ``torch.profiler`` records, a span opens
  ``torch.profiler.record_function(name)``: a ``user_annotation`` row of
  the trace, on the clock of the caller's own ranges and of the device's
  operations.
- Otherwise a span costs one check of the profiler's flag.

``count(name)`` adds one to this thread's innermost launch's counts
(``LaunchResult.counts``); outside a launch it does nothing.

Every span is named ``rt.<...>`` (the kernels' C entries are ``rt_*``), so
no name of the program's is a name a caller gives its own ranges.  The
self time of ``rt.map`` and ``rt.timeloop`` is the bind, the cache key and
the window's choice.  The spans:

===================== ============================================ ========
span                  what                                         phase
===================== ============================================ ========
``rt.launch``         an ``st.launch`` target                      total
``rt.map``            an ``st.map`` application                    —
``rt.map.launch``     its plan's launch (arguments, library, call) kernel
``rt.map.sync``       on one CUDA device its wait for the          kernel
                      application before it (the host runs at
                      most one ahead) or, with no launch open, for
                      itself; a sync on a distributed backend; a
                      launch's drain of the one left running; the
                      cost model's probe's sync after each
``rt.timeloop``       an ``st.timeloop`` call                      —
``rt.build``          a cache miss's lowering (map or engine)      codegen
``rt.autotune``       the launch's tune of a time loop             autotune
``rt.engine.scalars`` the scalars in a window's form               —
``rt.engine.window``  one fusion window, its sync included         kernel
``rt.engine.pad``     the layout cut (hopper)                      layout
``rt.engine.steps``   the window's launches (hopper)               —
``rt.engine.unpad``   the layout write-back (hopper)               —
``rt.engine.sync``    the window's wait for the device             —
``rt.engine.between`` the ``between`` hook                         —
``rt.engine.scatter`` state into the mesh's shards                 scatter
``rt.engine.gather``  state out of the shards                      gather
``rt.inject_source``  ``acoustic.inject_source``;                  —
                      ``tti.inject_source``, one span for both
                      fields
===================== ============================================ ========

The counters (``LaunchResult.counts``):

===================== ===================================================
counter               what
===================== ===================================================
``rt.map.apps``       ``st.map`` applications on one CUDA device
``rt.map.overlapped`` those launched while the application before still
                      ran on the card: in a step loop whose host work
                      is shorter than the kernel, all but a launch's
                      first
===================== ===================================================
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

PREFIX = "rt."


class _Sink(threading.local):
    profile: Optional[Dict[str, float]] = None
    counts: Optional[Dict[str, int]] = None


_SINK = _Sink()


class _Off:
    """The span of a stretch nobody measures."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "phase", "profile", "recording", "_range", "_t0")

    def __init__(self, name, phase, profile, recording):
        self.name, self.phase, self.profile = name, phase, profile
        self.recording = recording

    def __enter__(self):
        # the profiler's range outside the timed stretch, so a traced
        # run's phases leave out its cost
        self._range = record_function(self.name) if self.recording else None
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.profile is not None:
            dt = time.perf_counter() - self._t0
            self.profile[self.phase] = self.profile.get(self.phase, 0.0) + dt
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, phase: Optional[str] = None):
    """A context manager over a stretch of host work named ``name``; its
    seconds go to the innermost launch's profile under ``phase``, and while
    the profiler records it is a ``record_function`` range."""
    profile = _SINK.profile if phase is not None else None
    recording = _profiler_enabled()
    if profile is None and not recording:
        return _OFF
    return _Span(name, phase, profile, recording)


def count(name: str) -> None:
    """Add one to ``name`` in the innermost launch's counts."""
    counts = _SINK.counts
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def collect(profile: Dict[str, float],
            counts: Optional[Dict[str, int]] = None) -> Iterator[Dict[str, float]]:
    """Make ``profile`` (and ``counts``) this thread's sink of the spans'
    phases (and of ``count``) for the block; the enclosing sink (an outer
    launch's, or none) resumes after."""
    prev = _SINK.profile, _SINK.counts
    _SINK.profile, _SINK.counts = profile, counts
    try:
        yield profile
    finally:
        _SINK.profile, _SINK.counts = prev
