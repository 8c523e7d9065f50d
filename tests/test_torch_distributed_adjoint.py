"""The sharded adjoint (``distributed.sharded_step``: per-shard VJPs of the
torch lowering and the transposed exchange, ``HaloSpec.transpose()``) and
resilience on a mesh of CPU devices, in f64: gradients against the JAX
package's single-device xla ``differentiable_run`` (``jax.grad``) and the
port's unsharded adjoint at ``rtol=1e-9, atol=1e-12`` (the JAX package's
own bound in ``tests/test_distributed_adjoint.py``), central differences
(on a coefficient cell next to a shard edge too), per-scenario scalars
and coefficient grids under ``batch=2``, masked windows, and
``run_resilient`` / ``resilient_grad`` with injected failures bit for bit
the uninterrupted sharded runs.  A sharded run keeps each grid's halo
with its name, so interiors are compared."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adjoint as jadjoint  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.core import timeloop as jtl  # noqa: E402
from repro_torch.core import adjoint, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.core import timeloop as tl  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.train.fault_tolerance import FailureInjector  # noqa: E402

MESH = make_mesh((4,), ("data",), devices=["cpu"])
NAME = "star2d2r"
K = suite.get_kernel(NAME)
SHAPE = (16, 12)
O = K.info.order
SWAP = suite.swap_pair(NAME)
HALOS = {g: (O, O) for g in K.ir.grid_params}
RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shards' tensors are small: torch's thread pool only adds
    overhead here, and oversubscribes the cores when test workers run side
    by side (this file takes 18 s on one thread, 33 s on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arrays_np(batch=0, seed=0):
    rng = np.random.default_rng(seed)
    lead = (batch,) if batch else ()
    out = {}
    for g in K.ir.grid_params:
        a = np.zeros(lead + tuple(s + 2 * O for s in SHAPE))
        a[idx(batch)] = rng.standard_normal(lead + SHAPE)
        out[g] = a
    return out


def idx(batch=0):
    return (slice(None),) * (1 if batch else 0) + tuple(slice(O, O + s) for s in SHAPE)


def engine(be, batch=0, mesh=MESH):
    return tl.TimeloopEngine(K.ir, HALOS, SHAPE, be, swap=SWAP, mesh=mesh,
                             batch=batch, differentiable=True)


def sharded(ts=1):
    return st.distributed(grid_axes=("data", None), time_steps=ts)


def port_grads(fn, arrs, batch=0, scal=None):
    """(output interiors, interior gradients) of the interior loss."""
    a = {g: torch.from_numpy(x).requires_grad_() for g, x in arrs.items()}
    out = fn(a, scal or {})
    loss = sum((out[g][idx(batch)] ** 2).sum() for g in SWAP)
    loss.backward()
    return ({g: out[g].detach()[idx(batch)].numpy() for g in out},
            {g: a[g].grad[idx(batch)].numpy() for g in a})


def jax_grads(steps, fuse, arrs, batch=0, **kw):
    with jax.enable_x64(True):
        eng = jtl.TimeloopEngine(jsuite.get_kernel(NAME).ir, HALOS, SHAPE, jst.xla(),
                                 swap=SWAP, batch=batch, differentiable=True)
        fn = jadjoint.differentiable_run(eng, steps, fuse_steps=fuse, **kw)
        a = {g: jnp.asarray(x) for g, x in arrs.items()}

        def loss(a):
            out = fn(a, {})
            return sum(jnp.sum(out[g][idx(batch)] ** 2) for g in SWAP)
        out = fn(a, {})
        g = jax.grad(loss)(a)
        return ({n: np.asarray(v)[idx(batch)] for n, v in out.items()},
                {n: np.asarray(v)[idx(batch)] for n, v in g.items()})


def assert_grads(got, want):
    for g in want:
        np.testing.assert_allclose(got[g], want[g], rtol=RTOL, atol=ATOL, err_msg=g)


@pytest.mark.parametrize("ts,shards", [(1, 4), (2, 4), (3, 2)])
def test_matches_jax_single_device_adjoint(ts, shards):
    arrs = arrays_np()
    m = make_mesh((shards,), ("data",), devices=["cpu"])
    out_d, g_d = port_grads(adjoint.differentiable_run(
        engine(sharded(ts), mesh=m), 6, fuse_steps=2 if ts < 3 else 3), arrs)
    out_x, g_x = jax_grads(6, 2 if ts < 3 else 3, arrs)
    assert_grads(out_d, out_x)
    assert_grads(g_d, g_x)


@pytest.mark.parametrize("ts,fuse", [(1, 2), (2, 3), (2, 5)])
def test_matches_the_unsharded_port(ts, fuse):
    arrs = arrays_np(seed=ts)
    out_d, g_d = port_grads(adjoint.differentiable_run(engine(sharded(ts)), 7,
                                                       fuse_steps=fuse), arrs)
    out_u, g_u = port_grads(adjoint.differentiable_run(
        engine(st.torch(), mesh=None), 7, fuse_steps=fuse), arrs)
    assert_grads(out_d, out_u)
    assert_grads(g_d, g_u)


@st.kernel
def heat(u: st.grid, v: st.grid, c: st.grid, a: st.f32):
    v.at(0, 0).set(u.at(0, 0) + a * c.at(0, 0) * (
        u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1)
        - 4.0 * u.at(0, 0)))


HSHAPE = (16, 10)


def heat_fn(backend, mesh, batch=0, steps=4):
    halos = {g: (1, 1) for g in ("u", "v", "c")}
    eng = tl.TimeloopEngine(heat.ir, halos, HSHAPE, backend, swap=("v", "u"),
                            mesh=mesh, batch=batch, differentiable=True)
    return adjoint.differentiable_run(eng, steps, fuse_steps=2)


def heat_arrays(batch=0):
    return {g: st.grid(dtype=st.f64, shape=HSHAPE, order=1, batch=batch or None,
                       device="cpu").randomize(i).data for i, g in enumerate("uvc")}


def test_coefficient_and_scalar_grads_batched():
    arrs = heat_arrays(batch=2)
    ix = (slice(None),) + tuple(slice(1, 1 + s) for s in HSHAPE)
    res = []
    for be, m in ((st.distributed(grid_axes=("data", None)), MESH), (st.torch(), None)):
        a = {g: x.clone().requires_grad_() for g, x in arrs.items()}
        s = {"a": torch.tensor([0.1, 0.15], dtype=torch.float64, requires_grad=True)}
        (heat_fn(be, m, 2)(a, s)["v"][ix] ** 2).sum().backward()
        res.append(({g: a[g].grad[ix].numpy() for g in a}, s["a"].grad.numpy()))
    assert_grads(res[0][0], res[1][0])
    np.testing.assert_allclose(res[0][1], res[1][1], rtol=RTOL)
    assert np.linalg.norm(res[0][0]["c"]) > 0 and res[0][1].shape == (2,)
    # per-scenario isolation: a loss of scenario 1 leaves scenario 0's at 0
    a = {g: x.clone().requires_grad_() for g, x in arrs.items()}
    out = heat_fn(st.distributed(grid_axes=("data", None)), MESH, 2)(
        a, {"a": torch.tensor([0.1, 0.15], dtype=torch.float64)})
    (out["v"][1][1:-1, 1:-1] ** 2).sum().backward()
    assert float(a["u"].grad[0].norm()) == 0.0 and float(a["u"].grad[1].norm()) > 0


@pytest.mark.parametrize("row", [3, 4, 7, 8])
def test_central_difference_on_a_cell_at_a_shard_edge(row):
    """The coefficient cell at local row 3/0 of shards 0/1 (global rows 3,
    4) and 7/8: its cotangent comes back through the transposed exchange
    from the neighbour's halo reads."""
    arrs = heat_arrays()
    fn = heat_fn(st.distributed(grid_axes=("data", None)), MESH, steps=6)
    s = {"a": torch.tensor(0.12, dtype=torch.float64)}
    ix = tuple(slice(1, 1 + n) for n in HSHAPE)

    def loss(a):
        return float((fn(a, s)["v"][ix] ** 2).sum())
    a = {g: x.clone().requires_grad_() for g, x in arrs.items()}
    (fn(a, s)["v"][ix] ** 2).sum().backward()
    cell = (1 + row, 1 + 5)
    eps = 1e-6
    hi = {g: x.clone() for g, x in arrs.items()}
    lo = {g: x.clone() for g, x in arrs.items()}
    hi["c"][cell] += eps
    lo["c"][cell] -= eps
    fd = (loss(hi) - loss(lo)) / (2 * eps)
    ad = float(a["c"].grad[cell])
    assert abs(ad - fd) <= 1e-6 * max(abs(fd), 1e-8), (ad, fd)
    assert abs(ad) > 0


def test_masked_adjoint_matches_unsharded_and_jax():
    B, steps = 2, 4
    arrs = arrays_np(batch=B)
    mask = np.ones((B,) + SHAPE, bool)
    mask[1, :, 6:] = False
    limits = np.asarray([steps, 2], np.int32)
    kw = {"domain_mask": torch.as_tensor(mask), "step_limits": torch.as_tensor(limits)}
    out_d, g_d = port_grads(adjoint.differentiable_run(
        engine(sharded(), batch=B), steps, fuse_steps=2, **kw), arrs, batch=B)
    out_u, g_u = port_grads(adjoint.differentiable_run(
        engine(st.torch(), batch=B, mesh=None), steps, fuse_steps=2, **kw), arrs, batch=B)
    for g in out_u:
        assert np.array_equal(out_d[g], out_u[g]), g
    assert_grads(g_d, g_u)
    out_x, g_x = jax_grads(steps, 2, arrs, batch=B, domain_mask=jnp.asarray(mask),
                           step_limits=jnp.asarray(limits))
    assert_grads(out_d, out_x)
    assert_grads(g_d, g_x)
    # a frozen cell deep in the masked half passes through: its gradient
    # is 2 × its value
    frozen = (1, 4, 8)
    for g in SWAP:
        np.testing.assert_allclose(g_d[g][frozen], 2.0 * out_d[g][frozen], rtol=1e-12)


def test_transposed_exchange_is_the_adjoint_of_the_exchange():
    """<exchange(x), y> == <x, exchange_T(y)> on the shards' tensors: the
    transpose adds each halo cell's value into the edge cell it was copied
    from."""
    from repro_torch.core import distributed as dist
    step = dist.sharded_step(K.ir, SHAPE, sharded(), MESH, SWAP)
    lay = step.layout
    rng = np.random.default_rng(3)

    def rand():
        return [{g: torch.from_numpy(rng.standard_normal(lay.shape(g)))
                 for g in K.ir.grid_params} for _ in range(lay.n)]
    x, y = rand(), rand()
    ex = [{g: t.clone() for g, t in b.items()} for b in x]
    lay.exchange(ex, step._ex)
    ey = [{g: t.clone() for g, t in b.items()} for b in y]
    lay.exchange(ey, step._ex_T)
    # the exchange overwrites the halos it fills: as a linear map it is
    # the identity on every other cell and "copy" on the filled ones; its
    # transpose moves those cells' weight to the sources and zeroes them
    for i, b in enumerate(ey):
        for g, t in b.items():
            for e in step.spec.exchanges([g]):
                if lay.neighbor(i, e.axis, e.neighbor) is None:
                    continue
                P = lay.pads[g]
                t[tuple(slice(p + o, p + o + s) for p, o, s in
                        zip(P, e.offset, e.size))] = 0
    lhs = sum(float((a[g] * b[g]).sum()) for a, b in zip(ex, y) for g in a)
    rhs = sum(float((a[g] * b[g]).sum()) for a, b in zip(x, ey) for g in a)
    assert lhs == pytest.approx(rhs, rel=1e-12)


# ---- resilience on a 4-shard mesh --------------------------------------------
def test_run_resilient_on_a_mesh_is_bit_exact(tmp_path):
    be = st.distributed(grid_axes=("data", None), time_steps=2)
    inits = {g: torch.from_numpy(a.astype(np.float32)) for g, a in arrays_np().items()}

    def eng():
        return tl.TimeloopEngine(K.ir, HALOS, SHAPE, be, swap=SWAP, mesh=MESH)
    want = eng().run({g: a.clone() for g, a in inits.items()}, {}, 7, 2)
    restarts = []
    got = tl.run_resilient(eng(), dict(inits), {}, 7, 2, ckpt_dir=str(tmp_path / "ck"),
                           ckpt_every=1, injector=FailureInjector([1, 3]),
                           on_restart=lambda n, e: restarts.append(n))
    assert len(restarts) == 2
    for g in want:
        assert torch.equal(got[g], want[g]), g


def test_resilient_grad_on_a_mesh_resumes_mid_backward(tmp_path):
    be = st.distributed(grid_axes=("data", None), time_steps=2)
    arrs = {g: torch.from_numpy(a) for g, a in arrays_np().items()}

    def loss(a):
        return (a["v"][idx()] ** 2).sum()
    ref = tl.run_resilient(engine(be), dict(arrs), {}, 6, 2,
                           ckpt_dir=str(tmp_path / "ok"), loss=loss)
    # units 0-2 forward, 3 the seed, 4-6 backward: 5 is mid-backward
    got = tl.run_resilient(engine(be), dict(arrs), {}, 6, 2,
                           ckpt_dir=str(tmp_path / "fail"), loss=loss,
                           injector=FailureInjector([5]))
    assert torch.equal(ref["value"], got["value"])
    for g in ref["grad_arrays"]:
        assert torch.equal(ref["grad_arrays"][g], got["grad_arrays"][g]), g
    # and the in-memory adjoint's
    a = {g: x.clone().requires_grad_() for g, x in arrs.items()}
    value = loss(adjoint.differentiable_run(engine(be), 6, fuse_steps=2)(a, {}))
    value.backward()
    assert float(value.detach()) == float(ref["value"])
    for g in a:
        np.testing.assert_allclose(ref["grad_arrays"][g].numpy(), a[g].grad.numpy(),
                                   rtol=1e-12, atol=0)
