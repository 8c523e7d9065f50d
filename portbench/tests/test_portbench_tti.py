"""The ``tti-512`` configuration's own numbers and inputs, and the fault
only a stencil with a source into two fields can have."""
import json
import math
import time

import pytest
import torch

from portbench import harness
from portbench.metrics import yardstick
from portbench.tests.conftest import small_cell

H100 = "NVIDIA H100 80GB HBM3"
CFG = json.loads((harness.HERE / "configs" / "tti-512.json").read_text())


def test_tti_step():
    # 12 grid passes × 4 B × 512³
    assert yardstick.bytes_moved(CFG, 1) == pytest.approx(6.442e9, rel=1e-3)
    assert yardstick.flops(CFG, 1) == pytest.approx(835 * 512 ** 3, rel=1e-9)
    # a step of st.map: one observable state a step; 835 FLOPs a point is
    # under the 960 where the operations would bind
    s, bound = yardstick.least_seconds(CFG, 1, 1, H100)
    assert bound == "bytes" and s * 1e3 == pytest.approx(1.923, abs=0.001)


def test_tti_inputs():
    """ε ≥ δ everywhere, both over their ranges by layer; θ and φ the
    configuration's ramps away from the lens; ``dt`` at Courant 0.4 of the
    fastest horizontal speed; every term of Hz nonzero at the source."""
    cell = harness.load_cell("tti-512-shot")
    st = cell.stencil
    cfg = {**cell.cfg, "shape": [512, 6, 6]}
    seed = 2 ** 31 + 5
    init, scalars = st.make_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator().manual_seed(seed)
    st.layers(cfg, gen, "cpu")
    outside = st.lens(cfg, gen, "cpu") == 0
    inner = (slice(4, -4),) * 3
    eps, delta, vp2 = (init[g][inner] for g in ("epsilon", "delta", "vp2"))
    assert bool((eps >= delta).all()) and not bool(outside.all())
    assert float(eps.min()) == pytest.approx(0.10) and float(eps.max()) == pytest.approx(0.25)
    assert float(delta.min()) == pytest.approx(0.05) and float(delta.max()) == pytest.approx(0.10)
    assert (len(torch.unique(eps[outside])) == len(torch.unique(vp2[outside]))
            == cfg["velocity"]["layers"])
    fastest = math.sqrt(float(vp2.max()) * (1 + 2 * float(eps.max())))
    assert scalars["dt"] * fastest == pytest.approx(0.4, rel=1e-6)
    # the ramps: θ along axis 2, φ along axis 1, at the cell's own size,
    # below the lens's reach
    shape = [48, 7, 9]
    small, _ = st.make_state({**cell.cfg, "shape": shape}, torch.Generator(), "cpu")
    deep = (slice(4 + 32, 4 + 48), slice(4, -4), slice(4, -4))
    assert torch.equal(small["theta"][deep], small["theta"][40:41, 4:5, 4:-4].expand(16, 7, 9))
    assert torch.equal(small["phi"][deep], small["phi"][40:41, 4:-4, 4:5].expand(16, 7, 9))
    n0, n1, n2 = cell.cfg["shape"]
    theta = st.ramp(0.15, 0.60, n2, 2, "cpu").flatten()
    phi = st.ramp(0.2, 1.2, n1, 1, "cpu").flatten()
    assert float(theta[0]) == pytest.approx(0.15) and float(theta[-1]) == pytest.approx(0.60)
    assert float(phi[0]) == pytest.approx(0.2) and float(phi[-1]) == pytest.approx(1.2)
    _, y, x = st.source_position(cell.cfg)
    a = math.sin(theta[x]) * math.cos(phi[y])
    b = math.sin(theta[x]) * math.sin(phi[y])
    c = math.cos(theta[x])
    assert min(abs(t) for t in (a * a, b * b, c * c, 2 * a * b, 2 * a * c, 2 * b * c)) > 0.05


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_tti_lens(seed):
    """The seeded lens: at its centre, 6–12 cells below the source and up
    to 6 aside, θ, φ, ε and δ gain the configuration's amplitudes and vp
    loses 10 %; zero at the source and beyond its radius; ε − δ grows in
    it and the horizontal speed vp·√(1+2ε) stays under its layer's; the
    seed moves it."""
    cell = harness.load_cell("tti-512-shot")
    st, an = cell.stencil, cell.cfg["anomaly"]
    cfg = {**cell.cfg, "shape": [64, 64, 64]}
    bumps = []
    for s in (seed, seed + 1):
        gen = torch.Generator().manual_seed(s)
        st.layers(cfg, gen, "cpu")
        bumps.append(st.lens(cfg, gen, "cpu"))
    bump = bumps[0]
    assert not torch.equal(bumps[0], bumps[1])
    centre = [int(i) for i in (bump == bump.max()).nonzero()[0]]
    z, y, x = st.source_position(cfg)
    assert float(bump.max()) == 1.0 and float(bump[z, y, x]) == 0.0
    assert an["depth"][0] <= centre[0] - z <= an["depth"][1]
    assert abs(centre[1] - y) <= an["lateral"] and abs(centre[2] - x) <= an["lateral"]
    assert int((bump > 0).sum()) < 4 / 3 * math.pi * an["radius"] ** 3
    init, _ = st.make_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    at = tuple(4 + c for c in centre)
    flat, _ = st.make_state({**cfg, "anomaly": {**an, **{k: 0.0 for k in
                                                         ("theta", "phi", "epsilon", "delta", "vp")}}},
                            torch.Generator().manual_seed(seed), "cpu")
    for g in ("theta", "phi", "epsilon", "delta"):
        assert float(init[g][at] - flat[g][at]) == pytest.approx(an[g], rel=1e-5), g
    assert float(init["vp2"][at] / flat["vp2"][at]) == pytest.approx((1 + an["vp"]) ** 2, rel=1e-5)
    speed, layer = (s["vp2"] * (1 + 2 * s["epsilon"]) for s in (init, flat))
    assert bool((speed <= layer * (1 + 1e-6)).all())
    assert bool((init["epsilon"] - init["delta"] >= flat["epsilon"] - flat["delta"] - 1e-7).all())


def test_source_into_p_alone_reads_incorrect(monkeypatch):
    """The program's source added to ``p`` and left out of ``r``."""
    from repro_torch.core import acoustic, tti
    monkeypatch.setattr(tti, "inject_source", lambda p, r, t, pos=None, amp=1.0:
                        acoustic.inject_source(p, t, pos=pos, amp=amp))
    out = harness.run(small_cell("tti-512-shot"), 17, 0.2, False, "cpu", time.perf_counter)
    assert out["correct"] is False
    assert out["checks"]["r1"]["value"] > out["checks"]["r1"]["limit"]
