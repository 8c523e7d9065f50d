"""The distributed stencil layer (``core/distributed.py``, ``launch/mesh.py``)
on meshes of CPU devices, held against the JAX package's single-device
``st.xla()`` runs on the same numpy inputs (the JAX package's own sharded
tests need forced host devices that its installed JAX does not give): one
``st.map`` application domain-decomposed (the suite kernels of the JAX
test, overlap on and off, inner ``st.torch()`` and ``st.hopper(template=
"gmem")`` on its plain versions), time skewing at k = 2 and 3 (and a
hopper inner's ``time_block``), and the fused window of ``st.timeloop``
(depths 1–3 with a remainder group, overlap on and off, acoustic ISO with
its PML and the source in ``between``, ``batch=2``, masked windows).
Tolerance: f32 1e-5, f64 1e-12 of each field's max; a mesh of one shard
equals the unsharded port bit for bit.  A sharded run keeps each grid's
halo with its name (the global zero halo), as the JAX package's does, so
interiors are compared."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.core import timeloop as jtl  # noqa: E402
from repro_torch.core import acoustic, suite  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.core import timeloop as tl  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402

CPU = [torch.device("cpu")]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shards' tensors are small: torch's thread pool only adds
    overhead here, and oversubscribes the cores when test workers run side
    by side (this file takes 18 s on one thread, 33 s on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(shape, names):
    return pmesh.make_mesh(shape, names, devices=CPU)


def close(got, want, tol):
    """Every field of ``want`` (numpy) within ``tol`` of its max."""
    for g, w in want.items():
        a = got[g].detach().cpu().numpy() if isinstance(got[g], torch.Tensor) else got[g]
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(a - w).max())
        assert err <= tol * scale, (g, err, scale)


def interior(a, order, nd, batch=False):
    idx = (slice(None),) * batch + (slice(order, -order),) * nd
    return np.asarray(a)[idx]


# ---- one st.map application, domain-decomposed -----------------------------
MAP_CASES = [  # the JAX test's: kernel, mesh, axis names, grid axes
    ("star2d2r", (8,), ("data",), ("data", None)),
    ("box2d1r", (4, 2), ("data", "model"), ("data", "model")),
    ("star3d2r", (2, 2, 2), ("pod", "data", "model"), ("pod", "data", "model")),
    ("star3d1r", (2, 2), ("data", "model"), ("data", "model", None)),
]


def _map_run(name, dtype, target_launch, grid_cls, n=3):
    k = (suite if grid_cls is st.grid else jsuite).get_kernel(name)
    nd = k.info.ndim
    shape = (32, 32) if nd == 2 else (16, 16, 32)
    kw = {"device": "cpu"} if grid_cls is st.grid else {}
    u = grid_cls(dtype=dtype, shape=shape, order=k.info.order, **kw).randomize(0)
    v = grid_cls(dtype=dtype, shape=shape, order=k.info.order, **kw)
    mod = st if grid_cls is st.grid else jst

    def tgt(u, v):
        for _ in range(n):
            mod.map(e=u.shape)(k)(u, v)
            (v, u) = (u, v)
        return u
    out = target_launch(tgt)(u, v).value
    return {"u": interior(np.asarray(out.data), k.info.order, nd)}


@pytest.mark.parametrize("inner", ["torch", "gmem"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("name,mshape,names,axes", MAP_CASES, ids=[c[0] for c in MAP_CASES])
def test_sharded_map_matches_jax_xla(name, mshape, names, axes, overlap, inner):
    be = st.distributed(grid_axes=axes, overlap=overlap,
                        inner=st.torch() if inner == "torch" else st.hopper(template=inner))
    got = _map_run(name, st.f32, st.launch(backend=be, mesh=mesh(mshape, names)), st.grid)
    want = _map_run(name, jst.f32, jst.launch(backend=jst.xla()), jst.grid)
    close(got, want, TOL[torch.float32])


@pytest.mark.parametrize("name", ["star2d2r", "star3d2r"])
def test_sharded_map_f64(name):
    axes = ("data", None) if name == "star2d2r" else ("data", "model", None)
    be = st.distributed(grid_axes=axes)
    got = _map_run(name, st.f64, st.launch(backend=be, mesh=mesh((4, 2)[:len(
        [a for a in axes if a])], ("data", "model")[:len([a for a in axes if a])])),
        st.grid)
    with jax.enable_x64(True):
        want = _map_run(name, jnp.float64, jst.launch(backend=jst.xla()), jst.grid)
    close(got, want, TOL[torch.float64])


@pytest.mark.parametrize("template", ["torch", "gmem", "shift"])
def test_mesh_of_one_equals_the_unsharded_port(template):
    inner = st.torch() if template == "torch" else st.hopper(template=template)
    be = st.distributed(grid_axes=("data", "model", None), inner=inner)
    got = _map_run("star3d1r", st.f32, st.launch(backend=be, mesh=mesh((1, 1), (
        "data", "model"))), st.grid)
    want = _map_run("star3d1r", st.f32, st.launch(backend=inner), st.grid)
    assert np.array_equal(got["u"], want["u"])


def test_map_errors_match_jax():
    k = suite.get_kernel("star2d1r")
    m = mesh((8,), ("data",))
    with pytest.raises(ValueError, match="not divisible"):
        dist.lower_distributed(k.ir, {"u": (1, 1), "v": (1, 1)}, (30, 30), None,
                               st.distributed(grid_axes=("data", None)), m)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        dist.lower_distributed(k.ir, {"u": (1, 1), "v": (1, 1)}, (32, 32), None,
                               st.distributed(grid_axes=("model", None)), m)
    with pytest.raises(ValueError, match="requires launch"):
        dist.lower_distributed(k.ir, {}, (32, 32), None,
                               st.distributed(grid_axes=("data", None)), None)
    with pytest.raises(ValueError, match="two grid axes"):
        dist.lower_distributed(k.ir, {}, (32, 32), None,
                               st.distributed(grid_axes=("data", "data")), m)


def test_mesh_placement():
    m = pmesh.make_mesh((2, 3), ("a", "b"), devices=["cpu"])
    assert m.shape == {"a": 2, "b": 3} and m.size == 6
    assert {str(d) for d in m.devices.flat} == {"cpu"}
    assert pmesh.mesh_axes(m) == {"a": 2, "b": 3}
    assert pmesh.mesh_axes({"data": 4}) == {"data": 4}
    assert pmesh.make_scaling_mesh(4, devices=["cpu"]).shape == {"data": 4}
    assert pmesh.make_host_mesh(2, devices=["cpu"] * 4).shape == {"data": 2, "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh((2,), ("data",))


# ---- acoustic ISO: time skewing and the fused window -----------------------
ASHAPE = (48, 32, 24)
AMESH = ((4, 2), ("data", "model"))
AAXES = ("data", "model", None)


def _acoustic_fields():
    """The port's fields and the JAX package's, the same numbers."""
    p = acoustic.make_fields(ASHAPE, pml_width=4, device="cpu")
    acoustic.inject_source(p[1], 0)
    j = jacoustic.make_fields(ASHAPE, pml_width=4)
    for a, b in zip(p[:4], j[:4]):
        # a copy: jnp.asarray may share a numpy buffer, which the port's
        # in-place steps would then write
        b.data = jnp.asarray(a.data.numpy().copy())
    return p, j


def _jax_steps(j, n):
    """n single-device xla applications of the JAX package with the swap."""
    jst.launch(backend=jst.xla())(jacoustic.acoustic_target)(*j[:5], n)
    return {"p0": interior(j[0].data, 4, 3), "p1": interior(j[1].data, 4, 3)}


@pytest.mark.parametrize("k,inner", [(2, "torch"), (3, "torch"), (2, "gmem"),
                                     (3, "gmem"), ("tb2", "gmem")])
def test_time_skewing_matches_jax_xla(k, inner):
    p, j = _acoustic_fields()
    ir = acoustic.acoustic_iso_kernel.ir
    halos = {g: (4, 4, 4) for g in ir.grid_params}
    if k == "tb2":             # a hopper inner's time_block multiplies the depth
        be = st.distributed(grid_axes=AAXES, swap=("p0", "p1"),
                            inner=st.hopper(template=inner, time_block=2))
        k = 2
    else:
        be = st.distributed(grid_axes=AAXES, time_steps=k, swap=("p0", "p1"),
                            inner=st.torch() if inner == "torch"
                            else st.hopper(template=inner))
    fn = dist.lower_distributed(ir, halos, ASHAPE, None, be, mesh(*AMESH))
    assert fn.spec.depth == k
    arrays = {g: x.data for g, x in zip(ir.grid_params, p[:4])}
    out = fn(arrays, {"dt": p[4]})
    # k steps rotate the pair k times: the names follow the buffers
    got = {"p0": interior(out["p0"], 4, 3), "p1": interior(out["p1"], 4, 3)}
    close(got, _jax_steps(j, k), TOL[torch.float32])


WINDOW_CASES = [  # time_steps, fuse_steps, overlap, inner
    (1, 1, True, "torch"), (1, 3, False, "torch"), (2, 3, True, "torch"),
    (2, 5, False, "torch"), (3, 7, True, "torch"), (3, 4, False, "torch"),
    (1, 4, True, "gmem"), (2, 5, True, "gmem"), (3, 7, False, "gmem"),
    (2, 3, True, "shift"),
]


@pytest.mark.parametrize("ts,fuse,overlap,inner", WINDOW_CASES,
                         ids=[f"k{a}-f{b}-{'ov' if c else 'sync'}-{d}"
                              for a, b, c, d in WINDOW_CASES])
def test_fused_window_matches_jax_xla(ts, fuse, overlap, inner):
    """14 steps of acoustic ISO with its PML and the source injected in
    ``between`` at every window boundary: windows of ``fuse`` steps, each
    ⌊fuse/k⌋ depth-k groups plus a remainder group."""
    steps = 14
    p, j = _acoustic_fields()
    be = st.distributed(grid_axes=AAXES, time_steps=ts, overlap=overlap,
                        inner=st.torch() if inner == "torch" else st.hopper(template=inner))

    def between(t, grids):
        acoustic.inject_source(grids["p1"], t)

    def jbetween(t, grids):
        jacoustic.inject_source(grids["p1"], t)
    res = st.launch(backend=be, mesh=mesh(*AMESH), fuse_steps=fuse)(
        acoustic.acoustic_target_fused)(*p[:5], steps, between=between)
    assert res.value.fuse_steps == fuse and res.value.windows == -(-steps // fuse)
    jst.launch(backend=jst.xla(), fuse_steps=fuse)(jacoustic.acoustic_target_fused)(
        *j[:5], steps, between=jbetween)
    got = {g: interior(x.data, 4, 3) for g, x in zip(("p0", "p1"), p[:2])}
    want = {g: interior(x.data, 4, 3) for g, x in zip(("p0", "p1"), j[:2])}
    close(got, want, TOL[torch.float32])
    assert {"scatter", "gather", "kernel"} <= set(res.profile)


def test_window_mesh_of_one_equals_the_unsharded_port():
    p, _ = _acoustic_fields()
    q = tuple(x.copy() for x in p[:4]) + (p[4],)
    be = st.distributed(grid_axes=AAXES)
    for fields, backend, m in ((p, be, mesh((1, 1), AMESH[1])), (q, st.torch(), None)):
        st.launch(backend=backend, mesh=m, fuse_steps=4)(acoustic.acoustic_target_fused)(
            *fields[:5], 10)
    for a, b in zip(p[:2], q[:2]):
        assert torch.equal(a.interior, b.interior)


def test_window_launch_counts_and_collective_bytes():
    """Every pass of a hopper inner is one K4 launch: a depth-d group runs d
    sub-steps, the first split into the deep interior and two bands a
    decomposed axis; the window's bytes are ``window_collective_bytes``,
    the sum of the slabs it copies."""
    from repro_torch.kernels.stencil import map_step as ms
    ir = acoustic.acoustic_iso_kernel.ir
    halos = {g: (4, 4, 4) for g in ir.grid_params}
    be = st.distributed(grid_axes=AAXES, time_steps=2, inner=st.hopper())
    eng = tl.TimeloopEngine(ir, halos, ASHAPE, be, swap=("p0", "p1"), mesh=mesh(*AMESH))
    win = eng.distributed_window(5, 5)
    assert win.groups == ((2, 2), (1, 1)) and win.overlap
    per_shard = 2 * (2 + 4) + (1 + 4)
    assert win.launches_per_scenario == 8 * per_shard
    copied = sum(ex.nbytes(4) for ex in win._coeff_ex)
    for count, d in win.groups:
        copied += count * sum(ex.nbytes(4) for ex in win._fns[d][1])
    assert copied == win.spec.window_collective_bytes(5, 4)
    p, _ = _acoustic_fields()
    counted = []
    plain = ms.map_step_plain

    def count(*a, **kw):
        counted.append(1)
        return plain(*a, **kw)
    ms.map_step_plain = count
    try:
        eng.run({g: x.data for g, x in zip(ir.grid_params, p[:4])}, {"dt": p[4]}, 5, 5)
    finally:
        ms.map_step_plain = plain
    assert len(counted) == win.launches_per_scenario


# ---- batch and masked windows (star2d2r, a 4-shard mesh) --------------------
K2 = "star2d2r"
BSHAPE = (32, 24)


def _batched_inputs(b=2, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    k = suite.get_kernel(K2)
    o = k.info.order
    full = (b,) + tuple(s + 2 * o for s in BSHAPE)
    arrays = {}
    for g in k.ir.grid_params:
        a = np.zeros(full, dtype)
        a[(slice(None),) + (slice(o, -o),) * 2] = rng.standard_normal((b,) + BSHAPE)
        arrays[g] = a
    return k, arrays


@pytest.mark.parametrize("ts", [1, 2])
def test_batched_window_matches_jax_xla(ts):
    k, arrays = _batched_inputs()
    halos = {g: (2, 2) for g in k.ir.grid_params}
    be = st.distributed(grid_axes=("data", None), time_steps=ts)
    eng = tl.TimeloopEngine(k.ir, halos, BSHAPE, be, swap=("v", "u"),
                            mesh=mesh((4,), ("data",)), batch=2)
    got = eng.run({g: torch.from_numpy(a.copy()) for g, a in arrays.items()}, {}, 6, 3)
    jeng = jtl.TimeloopEngine(jsuite.get_kernel(K2).ir, halos, BSHAPE, jst.xla(),
                              swap=("v", "u"), batch=2)
    want = jeng.run({g: jnp.asarray(a) for g, a in arrays.items()}, {}, 6, 3)
    close({g: interior(got[g], 2, 2, True) for g in got},
          {g: interior(want[g], 2, 2, True) for g in want}, TOL[torch.float32])


def test_batched_scenarios_equal_their_own_sharded_runs():
    k, arrays = _batched_inputs()
    halos = {g: (2, 2) for g in k.ir.grid_params}
    be = st.distributed(grid_axes=("data", None), inner=st.hopper())
    m = mesh((4,), ("data",))
    batched = tl.TimeloopEngine(k.ir, halos, BSHAPE, be, swap=("v", "u"), mesh=m,
                                batch=2).run({g: torch.from_numpy(a.copy())
                                              for g, a in arrays.items()}, {}, 6, 3)
    for b in range(2):
        one = tl.TimeloopEngine(k.ir, halos, BSHAPE, be, swap=("v", "u"), mesh=m).run(
            {g: torch.from_numpy(a[b].copy()) for g, a in arrays.items()}, {}, 6, 3)
        for g in one:
            assert torch.equal(batched[g][b], one[g])


def test_masked_window_matches_jax_xla():
    k, arrays = _batched_inputs()
    halos = {g: (2, 2) for g in k.ir.grid_params}
    mask = np.ones((2,) + BSHAPE, bool)
    mask[1, :, 12:] = False
    limits = np.asarray([6, 3], np.int32)
    eng = tl.TimeloopEngine(k.ir, halos, BSHAPE, st.distributed(grid_axes=("data", None)),
                            swap=("v", "u"), mesh=mesh((4,), ("data",)), batch=2)
    got = eng.run({g: torch.from_numpy(a.copy()) for g, a in arrays.items()}, {}, 6, 4,
                  domain_mask=mask, step_limits=limits)
    jeng = jtl.TimeloopEngine(jsuite.get_kernel(K2).ir, halos, BSHAPE, jst.xla(),
                              swap=("v", "u"), batch=2)
    want = jeng.run({g: jnp.asarray(a) for g, a in arrays.items()}, {}, 6, 4,
                    domain_mask=jnp.asarray(mask), step_limits=jnp.asarray(limits))
    close({g: interior(got[g], 2, 2, True) for g in got},
          {g: interior(want[g], 2, 2, True) for g in want}, TOL[torch.float32])
    # a frozen cell keeps its value
    frozen = (1, 2 + 5, 2 + 20)
    assert got["u"][frozen] == arrays["u"][frozen] or got["v"][frozen] == arrays["u"][frozen]


def test_masked_window_needs_a_batched_torch_inner():
    k, arrays = _batched_inputs()
    halos = {g: (2, 2) for g in k.ir.grid_params}
    for batch, inner in ((2, st.hopper()), (0, st.torch())):
        eng = tl.TimeloopEngine(k.ir, halos, BSHAPE,
                                st.distributed(grid_axes=("data", None), inner=inner),
                                swap=("v", "u"), mesh=mesh((4,), ("data",)), batch=batch)
        with pytest.raises(ValueError, match="batched torch"):
            eng.check_masked()


def test_engine_refuses_a_missing_mesh_or_swap():
    k = suite.get_kernel(K2)
    halos = {g: (2, 2) for g in k.ir.grid_params}
    be = st.distributed(grid_axes=("data", None))
    with pytest.raises(ValueError, match="mesh"):
        tl.TimeloopEngine(k.ir, halos, BSHAPE, be, swap=("v", "u"))
    with pytest.raises(ValueError, match="swap"):
        tl.TimeloopEngine(k.ir, halos, BSHAPE, be, mesh=mesh((4,), ("data",)))
    with pytest.raises(ValueError, match="exceeds local extent"):
        tl.TimeloopEngine(k.ir, halos, BSHAPE, st.distributed(
            grid_axes=("data", None), time_steps=5), swap=("v", "u"),
            mesh=mesh((4,), ("data",))).distributed_window(5, 5)
