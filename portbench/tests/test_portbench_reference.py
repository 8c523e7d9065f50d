"""The plain references against the program's own torch lowering,
``st.torch()``, at 32³ on the CPU, on the benchmark's seeded inputs and
with the schedule of hooks the drivers run."""
import pytest
import torch

from portbench import check, harness
from portbench.tests.conftest import small_cell


def torch_run(cell, prog, schedule):
    """The program under ``st.torch()``, step by step as ``map_steps``
    does it."""
    from repro_torch.core import dsl as st
    w, o = prog.swap
    seis = []
    mapped = st.map(e=prog.grids[w].shape)(prog.kernel)
    launch = st.launch(backend=st.torch())(lambda *a: mapped(*a))
    for t in range(schedule.steps):
        if schedule.record_every and t % schedule.record_every == 0:
            seis.append(prog.record().clone())
        if schedule.inject_every and t % schedule.inject_every == 0:
            prog.inject(t)
        launch(*prog.args)
        gw, go = prog.grids[w], prog.grids[o]
        gw.data, go.data = go.data, gw.data
    out = {g: prog.grids[g].interior for g in prog.swap}
    if seis:
        out["seis"] = torch.stack(seis)
    return out


@pytest.mark.parametrize("name", ["star3d4r-512-fused", "acoustic-iso-512-shot"])
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


def test_acoustic_wave_meets_the_pml_and_an_interface():
    """At the cell's own geometry the shot is not trivial: the seeded
    model is layered, the source sits under the top PML."""
    cell = harness.load_cell("acoustic-iso-512-shot")
    cfg = {**cell.cfg, "shape": [512, 4, 4]}
    init, scalars = cell.stencil.make_state(cfg, torch.Generator().manual_seed(5), "cpu")
    vp = init["vp2"][4:-4, 6, 6].sqrt()
    assert float(vp[0]) == pytest.approx(1.5) and float(vp[-1]) == pytest.approx(4.5)
    assert len(torch.unique(vp)) == cfg["velocity"]["layers"]
    assert scalars["dt"] * 4.5 == pytest.approx(0.4, rel=1e-6)
    assert cell.stencil.source_position(cell.cfg)[0] == 12


def test_same_seed_same_inputs():
    cell = small_cell("acoustic-iso-512-shot")
    a, _ = cell.stencil.make_state(cell.cfg, torch.Generator().manual_seed(2 ** 32 + 3), "cpu")
    b, _ = cell.stencil.make_state(cell.cfg, torch.Generator().manual_seed(2 ** 32 + 3), "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
