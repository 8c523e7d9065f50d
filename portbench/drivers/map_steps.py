"""A user's own step loop (the paper's §6.2 host loop): closed-loop shots
of ``steps_per_solve`` steps under ``st.hopper()`` (its default template),
each step one ``st.map`` of the kernel over the interior and every
leapfrog pair trading buffers.  Before step ``t`` the receivers' plane is
copied into the seismogram on the card when ``t`` is a multiple of
``receivers_every`` (0: never), and the source's sample ``t`` is injected
when ``t`` is a multiple of ``source_every`` (0: never).  Each shot
starts from the seeded state.  The window ends at the first step past its
time; the shot it cut counts its completed steps, and ``finish`` runs the
rest of it for the check."""
from __future__ import annotations

import time

from portbench.check import Schedule
from portbench.drivers import Window, interiors, reset


class Driver:
    def __init__(self, prog, init, traffic, probe):
        from repro_torch.core import dsl as st
        self.prog, self.init, self.probe = prog, init, probe
        self.steps = int(traffic["steps_per_solve"])
        self.src = int(traffic.get("source_every") or 0)
        self.rec = int(traffic.get("receivers_every") or 0)
        if (self.src and prog.inject is None) or (self.rec and prog.record is None):
            raise ValueError("this stencil has no source or receivers to hook")
        self.schedule = Schedule(self.steps, self.src, self.rec)
        self.seis = None
        if self.rec:
            plane = prog.record()
            self.seis = plane.new_empty((-(-self.steps // self.rec),) + tuple(plane.shape))
        self.t = 0
        self._map = st.map(e=prog.grids[prog.pairs[0][0]].shape)(prog.kernel)
        # the grid objects stay; each step trades their buffers
        self._pairs = [(prog.grids[w], prog.grids[o]) for w, o in prog.pairs]

        @st.target
        def shot(end, deadline=None):
            return self._steps(end, deadline)
        self._launch = st.launch(backend=st.hopper())(shot)

    def _steps(self, end: int, deadline=None):
        """Steps ``self.t`` .. ``end`` - 1 of the shot, stopping after the
        first step that ends past ``deadline``."""
        prog = self.prog
        while self.t < end:
            t = self.t
            if self.rec and t % self.rec == 0:
                with self.probe.span("receivers"):
                    self.seis[t // self.rec].copy_(prog.record())
            if self.src and t % self.src == 0:
                with self.probe.span("inject_source"):
                    prog.inject(t)
            with self.probe.span("st.map"):
                self._map(*prog.args)
            for gw, go in self._pairs:
                gw.data, go.data = go.data, gw.data
            self.t += 1
            if deadline is not None and time.perf_counter() >= deadline:
                return

    def _run(self, end: int, deadline=None) -> int:
        """Advance the current shot (starting one from the seeded state at
        step 0); returns the steps done."""
        if self.t == 0:
            reset(self.prog, self.init, self.probe)
        t0 = self.t
        with self.probe.span("st.launch"):
            self._launch(end, deadline)
        done = self.t - t0
        if self.t == self.steps:
            self.t = 0
        return done

    def solve(self):
        with self.probe.span("shot"):
            self._run(self.steps)

    def warmup(self):
        self._run(min(self.steps, 2))
        self.t = 0

    def window(self, seconds: float) -> Window:
        marks, steps, attempted = [], 0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with self.probe.span("window"):
            while time.perf_counter() < deadline:
                attempted += 1
                a = self.probe.mark()
                with self.probe.span("shot"):
                    steps += self._run(self.steps, deadline)
                if self.t == 0:
                    marks.append((a, self.probe.mark()))
        wall = time.perf_counter() - t0
        return Window(wall, steps, steps, attempted, self.probe.seconds(marks))

    def finish(self):
        if self.t:
            self._run(self.steps)

    def outputs(self):
        out = interiors(self.prog)
        if self.seis is not None:
            out["seis"] = self.seis
        return out
