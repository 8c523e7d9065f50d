"""The comparison that decides ``correct``.

``reference_run`` works a solve out again with a stencil's plain reference
on the benchmark's own inputs, following the schedule the timed path ran:
before step ``t``, when ``t`` is a multiple of ``record_every`` the
receivers' plane is recorded as sample ``t // record_every``, then, when
``t`` is a multiple of ``inject_every``, the source's sample ``t`` is
added; then the update, then each leapfrog pair trades names.  ``compare``
reads, for each answer, the largest gap to the reference relative to the
reference's largest magnitude, against the cell's limit.  A gap that is
not finite fails.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from portbench.stencils import interior, leapfrog_pairs, pair_grids


@dataclasses.dataclass(frozen=True)
class Schedule:
    steps: int
    inject_every: int = 0
    record_every: int = 0


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def reference_run(ref, cfg, state, scalars, schedule: Schedule) -> Dict[str, torch.Tensor]:
    """The reference's answers: the interiors of every grid of every
    leapfrog pair after ``schedule.steps`` steps and, with receivers, the
    seismogram.  Advances ``state`` (full f32 grids) in place."""
    pairs = leapfrog_pairs(cfg["swap"])
    scratch = ref.prepare(state, scalars, cfg)
    seis = None
    r, e = schedule.record_every, schedule.inject_every
    if r:
        plane = ref.record(state, cfg)
        seis = torch.empty((-(-schedule.steps // r),) + tuple(plane.shape),
                           dtype=plane.dtype, device=plane.device)
    for t in range(schedule.steps):
        if r and t % r == 0:
            seis[t // r].copy_(ref.record(state, cfg))
        if e and t % e == 0:
            ref.inject(state, t, cfg)
        ref.update(state, scratch, cfg)
        for w, o in pairs:
            state[w], state[o] = state[o], state[w]
    del scratch
    out = {g: state[g][interior(cfg)] for g in pair_grids(pairs)}
    if seis is not None:
        out["seis"] = seis
    return out


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want| (the bare gap where ``want`` is 0);
    inf where the gap is not finite."""
    gap = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    value = gap / scale if scale > 0 else gap
    return value if value == value and value != float("inf") else float("inf")


def compare(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
            limits: Dict[str, float]) -> List[Check]:
    """One check an answer the limits name; an answer missing from ``got``
    fails."""
    return [Check(name, rel_gap(got[name], want[name]) if name in got else float("inf"),
                  float(limit))
            for name, limit in limits.items()]
