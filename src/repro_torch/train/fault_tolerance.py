"""Fault tolerance: the checkpoint-restart loop, the straggler watchdog,
preemption handling and failure injection for tests (the JAX package's
``train/fault_tolerance.py``, on PyTorch).

* **failure** → ``run_with_restarts`` restarts the run from the latest
  atomic checkpoint, in-process.  A deterministic data pipeline
  (``data.py``, counter-based) and the checkpointed state make the restart
  replay the lost steps exactly.
* **stragglers** → per-step wall-time watchdog; a step slower than
  ``threshold × median`` is recorded as a straggler event.
* **preemption** → a SIGTERM requests a final checkpoint at the next step
  boundary, then a clean return.

It restarts on a ``RuntimeError``, as the JAX package's does; in
PyTorch a CUDA launch failure or an out-of-memory error is one too, so a
real device fault is retried like an injected one.  Every restart is
therefore reported to ``on_restart`` (with the error), and
``FailureInjector.fired`` lists the failures it raised: a caller that
injects failures can require the restarts to be exactly those.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional

from . import checkpoint


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    median: float


class Watchdog:
    """Tracks per-step wall time; flags steps slower than ``threshold ×``
    the running median."""

    def __init__(self, threshold: float = 3.0, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, seconds: float) -> Optional[StragglerEvent]:
        med = (sorted(self.times)[len(self.times) // 2]
               if self.times else seconds)
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 5 and seconds > self.threshold * med:
            ev = StragglerEvent(step, seconds, med)
            self.events.append(ev)
            return ev
        return None


class PreemptionHandler:
    """SIGTERM → request a clean stop at the next step boundary."""

    def __init__(self):
        self.requested = False
        self._prev = None

    def install(self):
        def handler(signum, frame):
            self.requested = True
        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def uninstall(self):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)


class FailureInjector:
    """Deterministic failure injection for tests: raises RuntimeError at
    the given steps (once each); ``fired`` lists the steps it raised at."""

    def __init__(self, fail_at_steps):
        self.fail_at = set(fail_at_steps)
        self.fired: List[int] = []

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.fired.append(step)
            raise RuntimeError(f"injected node failure at step {step}")


def run_with_restarts(*,
                      init_fn: Callable[[], Dict],
                      step_fn: Callable[[Dict, int], Dict],
                      n_steps: int,
                      ckpt_dir: str,
                      ckpt_every: int = 10,
                      max_failures: int = 3,
                      shardings=None,
                      watchdog: Optional[Watchdog] = None,
                      injector: Optional[FailureInjector] = None,
                      on_metrics: Optional[Callable] = None,
                      on_restart: Optional[Callable[[int, BaseException], None]] = None
                      ) -> Dict:
    """Checkpoint-restart loop.

    ``step_fn(state, step) -> state`` advances the state one step.  A run
    resumes from the latest complete checkpoint in ``ckpt_dir`` (from
    ``init_fn()`` when there is none; ``init_fn`` also gives the template a
    checkpoint restores into), saves every ``ckpt_every`` steps, after the
    last one and when preempted, and restarts after a ``RuntimeError`` up to
    ``max_failures`` times; each restart calls ``on_restart(failures,
    error)`` first.  ``shardings`` goes to ``checkpoint.restore``: a
    restore places the state on the current mesh.  ``on_metrics(step, state, seconds)`` runs after every
    step.
    """
    failures = 0
    preempt = PreemptionHandler().install()
    try:
        while True:
            try:
                latest = checkpoint.latest_step(ckpt_dir)
                if latest is not None:
                    state = checkpoint.restore(ckpt_dir, init_fn(),
                                               shardings=shardings)
                    start = latest
                else:
                    state = init_fn()
                    start = 0
                for step in range(start, n_steps):
                    if injector is not None:
                        injector.maybe_fail(step)
                    t0 = time.perf_counter()
                    state = step_fn(state, step)
                    dt = time.perf_counter() - t0
                    if watchdog is not None:
                        watchdog.observe(step, dt)
                    if on_metrics is not None:
                        on_metrics(step, state, dt)
                    done = step + 1
                    if done % ckpt_every == 0 or done == n_steps \
                            or preempt.requested:
                        checkpoint.save(ckpt_dir, done, state)
                    if preempt.requested:
                        return state
                return state
            except RuntimeError as e:
                failures += 1
                if failures > max_failures:
                    raise
                if on_restart is not None:
                    on_restart(failures, e)
                # restart: fall through to restore-from-latest
                continue
    finally:
        preempt.uninstall()
