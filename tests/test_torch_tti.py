"""Pseudo-acoustic TTI on the port (``core/tti.py``) on the CPU: the
kernel's IR, its reduction to acoustic ISO without tilt or anisotropy, the
stability of the benchmark's model at its ``dt``, and the plain reference
(``portbench/reference/tti.py``) telling a wrong mixed-derivative weight
apart."""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import acoustic, tti  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "tti-512.json").read_text())


from portbench.conftest import one_thread  # noqa: E402,F401  (autouse: tensors of 18³ to 32³)


def benchmark(kind):
    """The benchmark's TTI stencil or reference module."""
    from portbench import harness
    return harness.load_module(kind, "tti")


def distinct_taps(kernel):
    taps = {}
    for t in kernel.ir.taps():
        taps.setdefault(t.grid, set()).add(t.offsets)
    return taps


def test_ir():
    k = tti.tti_kernel
    taps = distinct_taps(k)
    for f in ("p1", "r1"):
        assert len(taps[f]) == 73                      # 1 + 24 on the axes + 3 × 16
        assert k.info.halo_per_grid[f] == (4, 4, 4)
        assert sum(1 for o in taps[f] if sum(map(bool, o)) == 2) == 3 * 16
        assert all(max(map(abs, o)) <= 2 for o in taps[f] if sum(map(bool, o)) == 2)
    # the tilt at the 12 cells where G f is worked out, not at the centre
    ring = {tuple(d if a == ax else 0 for a in range(3)) for ax in range(3) for d in (-2, -1, 1, 2)}
    for g in ("theta", "phi"):
        assert taps[g] == ring, g
        assert k.info.halo_per_grid[g] == (2, 2, 2)
    for g in ("p0", "r0", "vp2", "epsilon", "delta", "damp"):
        assert taps[g] == {(0, 0, 0)}, g
    assert k.info.n_taps == 2 * 73 + 2 * 12 + 6
    assert k.info.output_grids == ("p0", "r0")
    assert k.info.flops_per_point == CONFIG["flops_per_point"]
    assert tuple(k.ir.grid_params) == tti.GRIDS


def steps(kernel, grids, pairs, n, inject=None):
    """``n`` steps of ``kernel`` under ``st.torch()``: the source, one
    ``st.map``, every pair traded."""
    step = st.map(e=grids[0].shape)(kernel)

    @st.target
    def run():
        for t in range(n):
            if inject:
                inject(t)
            step(*grids)
            for a, b in pairs:
                a.data, b.data = b.data, a.data
    st.launch(backend=st.torch())(run)()


def test_without_tilt_or_anisotropy_both_fields_are_acoustic():
    """θ = φ = ε = δ = 0: ``Hz = D_z D_z`` and ``H0 = ∇² − Hz``, so with one
    source in both fields p and r stay equal (every operation the same on
    equal operands) and ``p_tt = vp²(H0 p + Hz r) = vp² ∇² p``: acoustic
    ISO.  The two kernels round differently (acoustic: one ring of six taps
    at each distance; TTI: ∂zz + ∂yy + ∂xx, each with its own centre term,
    then ``Hz`` taken off and added back), so after 60 steps they differ by
    f32 rounding: within 1e-5 of the field's largest magnitude."""
    shape, n = (32, 32, 32), 60
    f = tti.make_fields(shape, pml_width=4, vp=1.5, epsilon=0.0, delta=0.0, theta=0.0,
                        phi=0.0, dt=0.3, device="cpu")
    p0, p1, r0, r1 = f[:4]
    steps(tti.tti_kernel, f, ((p0, p1), (r0, r1)), n,
          lambda t: tti.inject_source(p1, r1, t))
    a0, a1, vp2, damp, dt = acoustic.make_fields(shape, pml_width=4, vp=1.5, dt=0.3,
                                                 device="cpu")
    steps(acoustic.acoustic_iso_kernel, (a0, a1, vp2, damp, dt), ((a0, a1),), n,
          lambda t: acoustic.inject_source(a1, t))
    assert torch.equal(p1.data, r1.data) and torch.equal(p0.data, r0.data)
    scale = float(a1.interior.abs().max())
    assert scale > 0.1
    assert float((p1.interior - a1.interior).abs().max()) <= 1e-5 * scale
    assert float((p0.interior - a0.interior).abs().max()) <= 1e-5 * scale


def test_the_benchmarks_model_is_stable_at_its_dt():
    """The reference at 24³ (PML 4) on the configuration's model squeezed
    into the box (its layers, anisotropy, tilt ramps and lens), at its
    ``dt`` and with its source: after the wavelet has passed the PML takes
    the wave out; the largest |p| of the last 100 of 800 steps is under a
    tenth of the shot's.  ``Hz = −Gᵀ G`` keeps the operator symmetric
    however fast the tilt turns (21 times the configuration's rate a cell
    here)."""
    from portbench import check
    cfg = {**CONFIG, "shape": [24, 24, 24], "pml_width": 4}
    state, scalars = benchmark("stencils").make_state(cfg, torch.Generator().manual_seed(3),
                                                      "cpu")
    ref = benchmark("reference")
    peaks = []

    class Probe:
        """The reference, with the peak |p1| after each step."""
        prepare, inject, record = ref.prepare, ref.inject, ref.record

        @staticmethod
        def update(state, scratch, cfg):
            ref.update(state, scratch, cfg)
            peaks.append(float(state["p0"].abs().max()))   # the new p, before the trade
    check.reference_run(Probe, cfg, state, scalars, check.Schedule(800, 1, 0))
    assert all(p == p for p in peaks) and max(peaks) > 0.1
    assert max(peaks[-100:]) < 0.1 * max(peaks)
    theta = state["theta"][4:-4, 4:-4, 4:-4]
    assert float(theta.max() - theta.min()) > 0.45      # the ramp and the lens


def random_state(cfg, seed):
    """The benchmark's seeded model with standard-normal wavefields."""
    gen = torch.Generator().manual_seed(seed)
    state, scalars = benchmark("stencils").make_state(cfg, gen, "cpu")
    inner = tuple(slice(4, 4 + n) for n in cfg["shape"])
    for g in ("p0", "p1", "r0", "r1"):
        state[g][inner] = torch.randn(tuple(cfg["shape"]), generator=gen)
    return state, scalars


@pytest.mark.parametrize("wrong", [False, True], ids=["weights", "w_minus_2_flipped"])
def test_the_reference_tells_a_wrong_mixed_weight(monkeypatch, wrong):
    """Five steps from random wavefields under ``st.torch()`` against the
    reference: the kernel as written matches it (both sum in the same
    order); with the sign of the first derivatives' ``w_{-2}`` flipped (in
    ``G`` and in ``Hz``'s outer ``D``, the mixed terms' weights) it does
    not."""
    from portbench import check
    cfg = {**CONFIG, "shape": [20, 18, 22], "pml_width": 3}
    state, scalars = random_state(cfg, 11)
    if wrong:
        monkeypatch.setitem(tti.FIRST, -2, -tti.FIRST[-2])
    kernel = tti.make_kernel()
    grids = [st.grid(shape=tuple(cfg["shape"]), order=4, data=state[g].clone())
             for g in tti.GRIDS] + [scalars["dt"]]
    by = dict(zip(tti.GRIDS, grids))
    steps(kernel, grids, ((by["p0"], by["p1"]), (by["r0"], by["r1"])), 5)
    want = check.reference_run(benchmark("reference"), cfg, state, scalars, check.Schedule(5))
    gaps = [check.rel_gap(by[g].interior, want[g]) for g in ("p0", "p1", "r0", "r1")]
    if wrong:
        assert min(gaps[1], gaps[3]) > 1e-2, gaps       # the newest p and r
    else:
        assert max(gaps) < 2e-6, gaps


def test_inject_source_adds_the_sample_to_both_fields():
    f = tti.make_fields((6, 7, 8), pml_width=1, device="cpu")
    p, r = f[1], f[3]
    tti.inject_source(p, r, 40, pos=(2, 3, 4), amp=2.0)
    want = 2.0 * acoustic.source_wavelet(40)
    for g in (p, r):
        assert float(g.interior[2, 3, 4]) == pytest.approx(want)
        assert float(g.interior.abs().sum()) == pytest.approx(abs(want))


def test_the_gmem_build_is_budgeted_for_what_its_lanes_hold():
    """K4 gmem's TTI build holds 108 registers a lane across its planes and
    is budgeted for 3 blocks an SM; star3d4r's and acoustic's builds hold
    24 and 40, at least 24 under ``GMEM_HELD_LIMIT``, and keep the default
    budget, their sources without ``RT_MIN_BLOCKS``."""
    from repro_torch.core import suite
    from repro_torch.kernels.stencil import codegen

    def plan(k):
        return codegen.lower_hopper(k.ir, {g: (4, 4, 4) for g in k.ir.grid_params},
                                    (512, 512, 512), None, st.hopper())
    def held(p):
        return codegen.gmem_held_registers(p.gmem_column(), len(p.opnd_grids))
    p = plan(tti.tti_kernel)
    assert held(p) == 108
    assert "#define RT_MIN_BLOCKS 3\n" in p.source()
    for k, want in ((suite.get_kernel("star3d4r"), 24), (acoustic.acoustic_iso_kernel, 40)):
        p = plan(k)
        assert held(p) == want and codegen.GMEM_HELD_LIMIT - want >= 24, k.name
        assert "RT_MIN_BLOCKS" not in p.source(), k.name
