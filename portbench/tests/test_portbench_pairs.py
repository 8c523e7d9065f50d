"""A stencil with two leapfrog pairs runs through the harness as any other:
two fields, each updated from the other's 7-point Laplacian,

    a0 = 2·a1 − a0 + c·Δb1,    b0 = 2·b1 − b0 + c·Δa1,

with the pairs (a0, a1) and (b0, b1) trading buffers after every step.
The stencil, its binding and its plain reference are defined here; the
harness's driver, reset, rotation and check are the benchmark's own."""
import functools
import time
import types

import pytest
import torch

from portbench import check, harness
from portbench.stencils import Program, full_shape, interior, leapfrog_pairs

CFG = {"name": "twin-12", "stencil": "twin", "shape": [12, 12, 16], "order": 1,
       "dtype": "f32", "swap": [["a0", "a1"], ["b0", "b1"]], "c": 0.01}
TRAFFIC = {"driver": "map_steps", "steps_per_solve": 8, "source_every": 0,
           "receivers_every": 0}
LIMITS = {"a0": 1e-5, "a1": 1e-5, "b0": 1e-5, "b1": 1e-5}


@functools.lru_cache(maxsize=None)
def twin_kernel():
    from repro_torch.core import dsl as st

    @st.kernel
    def twin(a0: st.grid, a1: st.grid, b0: st.grid, b1: st.grid, c: st.f32):
        la = (a1.at(-1, 0, 0) + a1.at(1, 0, 0) + a1.at(0, -1, 0) + a1.at(0, 1, 0)
              + a1.at(0, 0, -1) + a1.at(0, 0, 1) - 6.0 * a1.at(0, 0, 0))
        lb = (b1.at(-1, 0, 0) + b1.at(1, 0, 0) + b1.at(0, -1, 0) + b1.at(0, 1, 0)
              + b1.at(0, 0, -1) + b1.at(0, 0, 1) - 6.0 * b1.at(0, 0, 0))
        a0.at(0, 0, 0).set(2.0 * a1.at(0, 0, 0) - a0.at(0, 0, 0) + c * lb)
        b0.at(0, 0, 0).set(2.0 * b1.at(0, 0, 0) - b0.at(0, 0, 0) + c * la)
    return twin


def make_state(cfg, gen, device):
    """Every grid standard-normal in the interior, zero in the halo."""
    state = {}
    for g in ("a0", "a1", "b0", "b1"):
        state[g] = torch.zeros(full_shape(cfg), dtype=torch.float32, device=device)
        state[g][interior(cfg)] = torch.randn(tuple(cfg["shape"]), generator=gen,
                                              device=device)
    return state, {"c": cfg["c"]}


def bind(cfg, tensors, scalars, dtype="f32", keep=None):
    """The program's grids on ``tensors``; ``keep``: how many of the pairs
    the program is told of (all by default)."""
    import numpy as np
    from repro_torch.core import dsl as st
    k = twin_kernel()
    grids = {n: st.grid(dtype=getattr(st, dtype), shape=tuple(cfg["shape"]),
                        order=cfg["order"], data=tensors[n])
             for n in k.ir.grid_params}
    return Program(kernel=k, grids=grids,
                   args=[grids[n] for n in k.ir.grid_params] + [np.float32(scalars["c"])],
                   pairs=leapfrog_pairs(cfg["swap"])[:keep])


def laplacian(x, cfg):
    o = cfg["order"]

    def at(*off):
        return x[tuple(slice(o + d, o + d + n) for d, n in zip(off, cfg["shape"]))]
    return (at(-1, 0, 0) + at(1, 0, 0) + at(0, -1, 0) + at(0, 1, 0)
            + at(0, 0, -1) + at(0, 0, 1) - 6.0 * at(0, 0, 0))


def update(state, scratch, cfg):
    """Both fields from the old state, then written in place."""
    i = interior(cfg)
    la, lb = laplacian(state["a1"], cfg), laplacian(state["b1"], cfg)
    a = 2.0 * state["a1"][i] - state["a0"][i] + scratch["c"] * lb
    b = 2.0 * state["b1"][i] - state["b0"][i] + scratch["c"] * la
    state["a0"][i], state["b0"][i] = a, b


REFERENCE = types.SimpleNamespace(
    prepare=lambda state, scalars, cfg: {"c": scalars["c"]}, update=update)


def twin_cell(keep=None, traffic=TRAFFIC):
    stencil = types.SimpleNamespace(kernel=twin_kernel, make_state=make_state,
                                    bind=functools.partial(bind, keep=keep))
    return harness.Cell(name="twin-12-map", chips=1, cfg=dict(CFG), traffic=dict(traffic),
                        stencil=stencil, reference=REFERENCE,
                        driver=harness.load_module("drivers", traffic["driver"]),
                        limits=dict(LIMITS), end_to_end=[], per_layer=[])


def two_shots(cell, seed=2 ** 31 + 11):
    """Two whole shots of the cell's driver, then the check of the last."""
    init, scalars, driver = harness.build(cell, seed, "cpu")
    driver.warmup()
    driver.solve()
    driver.solve()
    got, schedule = driver.outputs(), driver.schedule
    del driver
    return harness.judge(cell, got, schedule, init, scalars)


def test_two_pairs_read_correct():
    checks = two_shots(twin_cell())
    assert [c.name for c in checks] == ["a0", "a1", "b0", "b1"]
    assert all(c.ok for c in checks), checks


def test_second_pair_left_out_reads_incorrect():
    """The program told of the first pair alone: the second is neither
    reset between shots nor rotated, and every field goes wrong."""
    checks = {c.name: c for c in two_shots(twin_cell(keep=1))}
    assert not any(c.ok for c in checks.values()), checks


def test_a_whole_run_of_two_pairs_reads_correct():
    out = harness.run(twin_cell(), 5, 0.1, False, "cpu", time.perf_counter)
    assert out["correct"] is True and set(out["checks"]) == set(LIMITS)


def test_the_fused_driver_refuses_two_pairs():
    fused = {"driver": "fused_solves", "steps_per_solve": 8, "fuse_steps": None,
             "hooks_every": 0}
    with pytest.raises(ValueError, match="one leapfrog pair"):
        harness.build(twin_cell(traffic=fused), 1, "cpu")


@pytest.mark.parametrize("swap, pairs", [
    (["v", "u"], (("v", "u"),)),
    ([["v", "u"]], (("v", "u"),)),
    ([["a0", "a1"], ["b0", "b1"]], (("a0", "a1"), ("b0", "b1"))),
])
def test_leapfrog_pairs_takes_either_form(swap, pairs):
    assert leapfrog_pairs(swap) == pairs


@pytest.mark.parametrize("swap", [[], ["u"], ["u", "v", "w"], [["u", "v"], ["w"]], None])
def test_leapfrog_pairs_refuses_other_forms(swap):
    with pytest.raises(ValueError):
        leapfrog_pairs(swap)


def test_reference_rotates_every_pair():
    """One step of the reference by hand: both written fields, then both
    pairs traded."""
    gen = torch.Generator().manual_seed(3)
    state, scalars = make_state(CFG, gen, "cpu")
    start = {g: t.clone() for g, t in state.items()}
    out = check.reference_run(REFERENCE, CFG, state, scalars, check.Schedule(1))
    i = interior(CFG)
    want_a = 2.0 * start["a1"][i] - start["a0"][i] + CFG["c"] * laplacian(start["b1"], CFG)
    assert torch.equal(out["a1"], want_a) and torch.equal(out["a0"], start["a1"][i])
    assert torch.equal(out["b0"], start["b1"][i])
