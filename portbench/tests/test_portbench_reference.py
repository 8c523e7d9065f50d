"""The plain references against the program's own torch lowering,
``st.torch()``, at 32³ on the CPU, on the benchmark's seeded inputs and
with the schedule of hooks the drivers run."""
import pytest
import torch

from portbench import check
from portbench.stencils import pair_grids
from portbench.tests.conftest import SMALL, small_cell


def torch_run(cell, prog, schedule):
    """The program under ``st.torch()``, step by step as ``map_steps``
    does it."""
    from repro_torch.core import dsl as st
    seis = []
    pairs = [(prog.grids[w], prog.grids[o]) for w, o in prog.pairs]
    mapped = st.map(e=pairs[0][0].shape)(prog.kernel)
    launch = st.launch(backend=st.torch())(lambda *a: mapped(*a))
    for t in range(schedule.steps):
        if schedule.record_every and t % schedule.record_every == 0:
            seis.append(prog.record().clone())
        if schedule.inject_every and t % schedule.inject_every == 0:
            prog.inject(t)
        launch(*prog.args)
        for gw, go in pairs:
            gw.data, go.data = go.data, gw.data
    out = {g: prog.grids[g].interior for g in pair_grids(prog.pairs)}
    if seis:
        out["seis"] = torch.stack(seis)
    return out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_matches_st_torch(name):
    cell = small_cell(name)
    cell.cfg["shape"] = [32, 32, 32]
    gen = torch.Generator().manual_seed(2 ** 31 + 7)
    init, scalars = cell.stencil.make_state(cell.cfg, gen, "cpu")
    prog = cell.stencil.bind(cell.cfg, {n: t.clone() for n, t in init.items()}, scalars)
    tr = cell.traffic
    every = tr.get("hooks_every") or 0
    schedule = check.Schedule(tr["steps_per_solve"], tr.get("source_every", every),
                              tr.get("receivers_every", every))
    got = torch_run(cell, prog, schedule)
    want = check.reference_run(cell.reference, cell.cfg, init, scalars, schedule)
    assert set(got) == set(want) == set(cell.limits)
    for n in want:
        assert float(want[n].abs().max()) > 0
        assert check.rel_gap(got[n], want[n]) < 2e-6, n


def test_same_seed_same_inputs():
    for name in SMALL:
        cell = small_cell(name)
        a, _ = cell.stencil.make_state(cell.cfg, torch.Generator().manual_seed(2 ** 32 + 3), "cpu")
        b, _ = cell.stencil.make_state(cell.cfg, torch.Generator().manual_seed(2 ** 32 + 3), "cpu")
        assert all(torch.equal(a[n], b[n]) for n in a), name
