"""Closed-loop ``st.timeloop`` solves under ``st.hopper()`` (its default
template): each solve resets the written grids from the seeded state and
advances ``steps_per_solve`` steps in fusion windows of ``fuse_steps``
(null: the whole solve).  ``hooks_every`` > 0 records the receivers and
injects the source before step 0 and at every window boundary that is a
multiple of it (the engine's ``between`` hook; a multiple of
``fuse_steps``)."""
from __future__ import annotations

import time

from portbench.check import Schedule
from portbench.drivers import Window, interiors, reset


class Driver:
    def __init__(self, prog, init, traffic, probe):
        from repro_torch.core import dsl as st
        if len(prog.pairs) != 1:
            raise ValueError(f"the program's st.timeloop takes one leapfrog pair; "
                             f"this stencil has {len(prog.pairs)}")
        swap = prog.pairs[0]
        self.prog, self.init, self.probe = prog, init, probe
        self.steps = int(traffic["steps_per_solve"])
        self.every = int(traffic.get("hooks_every") or 0)
        fuse = traffic.get("fuse_steps") or self.every or None
        if self.every and fuse and self.every % fuse:
            raise ValueError("hooks_every must be a multiple of fuse_steps")
        if self.every and prog.inject is None:
            raise ValueError("this stencil has no source or receivers to hook")
        self.schedule = Schedule(self.steps, self.every, self.every if prog.record else 0)
        self.seis = None
        if prog.record is not None and self.every:
            plane = prog.record()
            self.seis = plane.new_empty((-(-self.steps // self.every),) + tuple(plane.shape))
        between = self._hook if self.every else None

        @st.target
        def solve(*args):
            return st.timeloop(self.steps, swap=swap, fuse_steps=fuse,
                               between=between)(prog.kernel)(*args)
        self._launch = st.launch(backend=st.hopper())(solve)

    def _hook(self, t, grids=None):
        if t % self.every:
            return
        if self.seis is not None:
            with self.probe.span("receivers"):
                self.seis[t // self.every].copy_(self.prog.record())
        with self.probe.span("inject_source"):
            self.prog.inject(t)

    def solve(self):
        with self.probe.span("solve"):
            reset(self.prog, self.init, self.probe)
            if self.every:
                self._hook(0)
            with self.probe.span("st.launch"):
                self._launch(*self.prog.args)

    def warmup(self):
        self.solve()

    def window(self, seconds: float) -> Window:
        marks = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with self.probe.span("window"):
            while True:
                a = self.probe.mark()
                self.solve()
                marks.append((a, self.probe.mark()))
                if time.perf_counter() >= deadline:
                    break
        wall = time.perf_counter() - t0
        n = len(marks)
        per_solve = -(-self.steps // self.every) if self.every else 1
        return Window(wall, n * self.steps, n * per_solve, n, self.probe.seconds(marks))

    def finish(self):
        """Every solve of the window ran whole."""

    def outputs(self):
        out = interiors(self.prog)
        if self.seis is not None:
            out["seis"] = self.seis
        return out
