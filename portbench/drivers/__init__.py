"""Window loops, one a file, found by the name a traffic file gives under
``driver``.  Each defines ``Driver(prog, init, traffic, probe)`` with:

- ``schedule``: the ``check.Schedule`` of one solve, for the reference;
- ``warmup()``: every shape the window uses, once;
- ``window(seconds) -> Window``: closed-loop solves, one client, until
  ``seconds`` have passed on the host clock;
- ``solve()``: one whole solve from the seeded state (the limits' script);
- ``finish()``: completes a solve the window's end cut off;
- ``outputs()``: the answers of the last solve, by the names the cell's
  limits give (the interiors of every grid of every leapfrog pair,
  ``seis``).

Each solve starts by resetting every grid of every leapfrog pair from the
seeded state held on the card (``init``).  In a traced run, spans
(``torch.profiler``'s ``record_function``) mark the calls into each layer:
``window``, ``solve`` or ``shot``, ``reset``, ``st.launch``, ``st.map``,
``inject_source``, ``receivers``; an untraced run opens none."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List

import torch
from torch.profiler import record_function

from portbench.stencils import pair_grids


@dataclasses.dataclass
class Window:
    """What a window did: its seconds on the host clock, the steps
    completed, the observable states (``yardstick.bytes_moved``'s
    boundaries), the solves attempted and each completed solve's
    seconds."""
    seconds: float
    steps: int
    boundaries: int
    attempted: int
    solve_s: List[float]


class Probe:
    """Marks around each solve (CUDA events on the card: its clock, in
    microseconds; the host clock elsewhere) and, when ``traced``, the
    benchmark's spans."""

    def __init__(self, device, traced: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.traced = traced

    def span(self, name: str):
        return record_function(name) if self.traced else contextlib.nullcontext()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def seconds(self, pairs) -> List[float]:
        if not self.cuda:
            return [b - a for a, b in pairs]
        torch.cuda.synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in pairs]


def reset(prog, init, probe) -> None:
    """Every grid of every leapfrog pair back to the seeded state."""
    with probe.span("reset"):
        for g in pair_grids(prog.pairs):
            prog.grids[g].data.copy_(init[g])


def interiors(prog) -> dict:
    return {g: prog.grids[g].interior for g in pair_grids(prog.pairs)}
