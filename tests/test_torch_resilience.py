"""Port parity: leapfrog checkpoint/restore (``timeloop.run_resilient``),
the fault-tolerant gradient (``adjoint.resilient_grad``,
``run_resilient(loss=)``) and the training restart, against the JAX
package's on ``st.xla()``.

A run that fails and restores replays the same windows on the same carry,
so the port's result is compared with the port's uninterrupted run BIT FOR
BIT (``torch.equal``); with the JAX package's ``run_resilient`` at the
forward tolerance of ``tests/test_torch_timeloop.py`` (atol 1e-5, suite
kernels) and its gradients within 1e-4 of each gradient's max, as in
``tests/test_torch_adjoint.py``.  ``st.hopper()`` runs on CPU tensors: the
kernels' plain versions, through the same engine and windows as on the
card.  The JAX package's fifth case (a distributed engine) waits for the
distributed layer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import adjoint as jadjoint  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.core import timeloop as jtimeloop  # noqa: E402
from repro.train.fault_tolerance import FailureInjector as JInjector  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core import adjoint, suite, timeloop  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.train import checkpoint, data, fault_tolerance, optimizer  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from repro_torch.train.fault_tolerance import FailureInjector  # noqa: E402

SHAPE = (12, 10)
STEPS = 7
FUSE = 2
ATOL = 1e-5
GRAD_RTOL = 1e-4     # f32, of each gradient's max
BACKENDS = {"torch": st.torch, "hopper": st.hopper,
            "shift-k2": lambda: st.hopper(template="shift", time_block=2)}


def _engine(backend="torch", differentiable=False, kernel="star2d1r", halo=1):
    k = suite.get_kernel(kernel) if isinstance(kernel, str) else kernel
    halos = {g: (halo,) * 2 for g in k.ir.grid_params}
    return timeloop.TimeloopEngine(k.ir, halos, SHAPE, BACKENDS[backend](),
                                   swap=("v", "u"), differentiable=differentiable)


def _jengine(differentiable=False, kernel="star2d1r"):
    k = jsuite.get_kernel(kernel) if isinstance(kernel, str) else kernel
    halos = {g: (1, 1) for g in k.ir.grid_params}
    return jtimeloop.TimeloopEngine(k.ir, halos, SHAPE, jst.xla(), swap=("v", "u"),
                                    differentiable=differentiable)


def _inits(seed=0):
    """The JAX test's grids: ``st.grid(...).randomize`` (bit-identical in
    the two packages), full halo-padded arrays."""
    k = suite.get_kernel("star2d1r")
    return {g: st.grid(st.f32, SHAPE, 1, device="cpu").randomize(seed + i).data.numpy()
            for i, g in enumerate(k.ir.grid_params)}


def _port(inits):
    return {g: torch.tensor(a) for g, a in inits.items()}


def _between(t, arrays):
    # a source injection mid-run: it must fire at the same window boundary
    # after a restart
    arrays["u"][3, 4] += np.float32(0.25 * t)
    return arrays


def _jbetween(t, arrays):
    arrays = dict(arrays)
    arrays["u"] = arrays["u"].at[3, 4].add(np.float32(0.25 * t))
    return arrays


def _assert_bit_exact(got, ref, label):
    for g in ref:
        assert torch.equal(got[g], ref[g]), f"{label}: grid '{g}' diverged after restore"


def _assert_close_to_jax(got, jgot):
    for g in jgot:
        np.testing.assert_allclose(got[g].numpy(), np.asarray(jgot[g]), rtol=0, atol=ATOL,
                                   err_msg=g)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_resilient_bit_exact_with_injected_failures(tmp_path, backend):
    inits = _inits()
    ref = _engine(backend).run(_port(inits), {}, STEPS, FUSE, _between)
    restarts = []
    inj = FailureInjector([1, 3])
    got = timeloop.run_resilient(_engine(backend), _port(inits), {}, STEPS, FUSE, _between,
                                 ckpt_dir=str(tmp_path / "ck"), ckpt_every=1, injector=inj,
                                 on_restart=lambda n, e: restarts.append(n))
    _assert_bit_exact(got, ref, "injected failures")
    assert inj.fired == [1, 3] and restarts == [1, 2]
    jgot = jtimeloop.run_resilient(_jengine(), dict(inits), {}, STEPS, FUSE, _jbetween,
                                   ckpt_dir=str(tmp_path / "jck"), ckpt_every=1,
                                   injector=JInjector([1, 3]))
    _assert_close_to_jax(got, jgot)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_resilient_checkpoint_cadence(tmp_path, backend):
    # sparse cadence: a failure between checkpoints rolls back and replays
    inits = _inits(1)
    ref = _engine(backend).run(_port(inits), {}, STEPS, FUSE)
    got = timeloop.run_resilient(_engine(backend), _port(inits), {}, STEPS, FUSE,
                                 ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                                 injector=FailureInjector([3]))
    _assert_bit_exact(got, ref, "sparse cadence")
    jgot = jtimeloop.run_resilient(_jengine(), dict(inits), {}, STEPS, FUSE,
                                   ckpt_dir=str(tmp_path / "jck"), ckpt_every=2,
                                   injector=JInjector([3]))
    _assert_close_to_jax(got, jgot)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_resume_from_existing_checkpoint_dir(tmp_path, backend):
    """A fresh run pointed at a populated directory resumes at the last
    window boundary instead of restarting from scratch."""
    ckpt = str(tmp_path / "ck")
    inits = _inits(2)
    timeloop.run_resilient(_engine(backend), _port(inits), {}, 4, FUSE, ckpt_dir=ckpt)
    assert checkpoint.steps(ckpt) == [1, 2]
    got = timeloop.run_resilient(_engine(backend), _port(inits), {}, 8, FUSE, ckpt_dir=ckpt)
    assert checkpoint.steps(ckpt) == [1, 2, 3, 4]
    ref = _engine(backend).run(_port(inits), {}, 8, FUSE)
    _assert_bit_exact(got, ref, "fresh-process resume")
    jgot = jtimeloop.run_resilient(_jengine(), dict(inits), {}, 8, FUSE,
                                   ckpt_dir=str(tmp_path / "jck"))
    _assert_close_to_jax(got, jgot)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_failures_beyond_budget_raise(tmp_path, backend):
    with pytest.raises(RuntimeError, match="injected node failure"):
        timeloop.run_resilient(_engine(backend), _port(_inits()), {}, STEPS, FUSE,
                               ckpt_dir=str(tmp_path / "ck"), max_failures=1,
                               injector=FailureInjector([0, 1]))


@pytest.mark.parametrize("backend", ["torch", "hopper", "shift-k2"])
def test_restart_before_the_first_checkpoint_starts_from_the_initial_fields(
        tmp_path, backend):
    """The engine advances tensors in place: a failure before the first
    checkpoint must restart from the initial fields, not from buffers the
    first windows already advanced; the caller's tensors stay as given."""
    inits = _inits(4)
    arrays = _port(inits)
    got = timeloop.run_resilient(_engine(backend), arrays, {}, STEPS, FUSE, _between,
                                 ckpt_dir=str(tmp_path / "ck"), ckpt_every=3,
                                 injector=FailureInjector([1]))
    for g, a in inits.items():
        np.testing.assert_array_equal(arrays[g].numpy(), a)
    ref = _engine(backend).run(_port(inits), {}, STEPS, FUSE, _between)
    _assert_bit_exact(got, ref, "restart before the first checkpoint")


# -- the fault-tolerant gradient -------------------------------------------------
@st.kernel
def _heat(u: st.grid, v: st.grid, c: st.grid, a: st.f32):
    v.at(0, 0).set(u.at(0, 0) + a * c.at(0, 0) * (
        u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1) - 4.0 * u.at(0, 0)))


@jst.kernel
def _jheat(u: jst.grid, v: jst.grid, c: jst.grid, a: jst.f32):
    v.at(0, 0).set(u.at(0, 0) + a * c.at(0, 0) * (
        u.at(-1, 0) + u.at(1, 0) + u.at(0, -1) + u.at(0, 1) - 4.0 * u.at(0, 0)))


def _heat_inputs(seed=0, nb=0):
    rng = np.random.default_rng(seed)
    lead = (nb,) if nb else ()
    arrays = {g: rng.standard_normal(lead + tuple(s + 2 for s in SHAPE)).astype(np.float32)
              for g in ("u", "v", "c")}
    arrays["c"] = np.abs(arrays["c"]) + 0.5
    return arrays


def _grad_between(t, arrays):
    # out of place: the adjoint differentiates the hook
    arrays = dict(arrays)
    src = torch.zeros_like(arrays["u"])
    src[..., 3, 4] = float(np.float32(0.25 * t))
    arrays["u"] = arrays["u"] + src
    return arrays


def _jgrad_between(t, arrays):
    arrays = dict(arrays)
    arrays["u"] = arrays["u"].at[..., 3, 4].add(np.float32(0.25 * t))
    return arrays


def _loss(out):
    return sum((o.double() ** 2).sum() for o in out.values())


def _jloss(out):
    return sum(jnp.sum(o ** 2) for o in out.values())


GRAD_STEPS, GRAD_FUSE = 9, 2     # 5 windows, 3 checkpoints: units 0-4, 5, 6-8


def _grad_case(tmp_path, backend, masked):
    nb = 2 if masked else 0
    inits = _heat_inputs(nb=nb)
    a = np.array([0.1, 0.05], np.float32) if nb else np.float32(0.1)
    kw = {}
    if masked:
        mask = np.ones((nb,) + SHAPE, bool)
        mask[1, :, 6:] = False
        kw = {"domain_mask": mask, "step_limits": np.array([9, 5], np.int32)}
    halos = {g: (1, 1) for g in inits}
    eng = timeloop.TimeloopEngine(_heat.ir, halos, SHAPE, BACKENDS[backend](),
                                  swap=("v", "u"), batch=nb, differentiable=True)
    # the uninterrupted run: every grid and the scalar require grad, as the
    # resilient run differentiates them all
    fn = adjoint.differentiable_run(eng, GRAD_STEPS, GRAD_FUSE, _grad_between, **kw)
    x = {g: torch.tensor(v, requires_grad=True) for g, v in inits.items()}
    ta = torch.tensor(a, requires_grad=True)
    value = _loss(fn(x, {"a": ta}))
    value.backward()
    inj = FailureInjector([2, 7])      # a forward window, a backward segment
    restarts = []
    if masked:
        got = adjoint.resilient_grad(eng, _port(inits), {"a": a}, GRAD_STEPS, _loss,
                                     fuse_steps=GRAD_FUSE, between=_grad_between,
                                     ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                                     injector=inj, on_restart=lambda n, e: restarts.append(n),
                                     **kw)
    else:
        got = timeloop.run_resilient(eng, _port(inits), {"a": a}, GRAD_STEPS, GRAD_FUSE,
                                     _grad_between, ckpt_dir=str(tmp_path / "ck"),
                                     ckpt_every=2, injector=inj, loss=_loss,
                                     on_restart=lambda n, e: restarts.append(n))
    assert inj.fired == [2, 7] and restarts == [1, 2]
    assert float(got["value"]) == float(value.detach())
    for g in inits:
        assert torch.equal(got["grad_arrays"][g], x[g].grad), g
    assert torch.equal(got["grad_scalars"]["a"], ta.grad)

    jeng = jtimeloop.TimeloopEngine(_jheat.ir, halos, SHAPE, jst.xla(), swap=("v", "u"),
                                    batch=nb, differentiable=True)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jgot = jadjoint.resilient_grad(jeng, {g: jnp.asarray(v) for g, v in inits.items()},
                                   {"a": jnp.asarray(a)}, GRAD_STEPS, _jloss,
                                   fuse_steps=GRAD_FUSE, between=_jgrad_between,
                                   ckpt_dir=str(tmp_path / "jck"), ckpt_every=2,
                                   injector=JInjector([2, 7]), **jkw)
    np.testing.assert_allclose(float(got["value"]), float(jgot["value"]), rtol=1e-5)
    pairs = [(got["grad_arrays"][g], jgot["grad_arrays"][g]) for g in inits]
    pairs.append((got["grad_scalars"]["a"], jgot["grad_scalars"]["a"]))
    for mine, theirs in pairs:
        theirs = np.asarray(theirs)
        scale = max(float(np.abs(theirs).max()), 1e-30)
        assert float(np.abs(mine.numpy() - theirs).max()) <= GRAD_RTOL * scale


@pytest.mark.parametrize("backend", ["torch", "hopper", "shift-k2"])
def test_resilient_grad_with_failures_forward_and_mid_backward(tmp_path, backend):
    _grad_case(tmp_path, backend, masked=False)


def test_resilient_grad_through_masked_windows(tmp_path):
    _grad_case(tmp_path, "torch", masked=True)


def test_resilient_grad_of_zero_steps(tmp_path):
    eng = _engine("torch", differentiable=True)
    inits = _port(_inits())
    got = adjoint.resilient_grad(eng, inits, {}, 0, _loss, ckpt_dir=str(tmp_path / "ck"))
    assert float(got["value"]) == float(_loss(inits))
    for g, a in inits.items():
        assert torch.equal(got["grad_arrays"][g], 2 * a)
    assert checkpoint.steps(str(tmp_path / "ck")) == []


# -- the training restart ----------------------------------------------------------
def test_training_restart_equals_the_uninterrupted_run(tmp_path):
    """``run_with_restarts`` around the port's train step on the tiny
    config: a failure at step 3 restores step 2's checkpoint (the optimizer
    advanced the params in place since) and replays; losses and params
    equal the uninterrupted run's bit for bit."""
    cfg = configs.tiny(configs.get("recurrentgemma-9b"))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=2)
    batch_fn = data.make_batch_fn(cfg, shape, seed=0)
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(lr=1e-3, warmup_steps=2,
                                                        total_steps=6))
    step = train_loop.make_train_step(cfg, tc)

    def run(losses):
        def one(state, i):
            state, metrics = step(state, batch_fn(i))
            losses[i] = float(metrics["loss"])
            return state
        return one

    def init_fn():
        return train_loop.init_state(cfg, device="cpu", seed=3)

    ref_losses = {}
    ref = init_fn()
    one = run(ref_losses)
    for i in range(6):
        ref = one(ref, i)
    losses, restarts = {}, []
    got = fault_tolerance.run_with_restarts(
        init_fn=init_fn, step_fn=run(losses), n_steps=6, ckpt_dir=str(tmp_path / "ck"),
        ckpt_every=2, injector=FailureInjector([3]),
        on_restart=lambda n, e: restarts.append(n))
    assert restarts == [1] and got["step"] == 6
    assert losses == ref_losses
    for a, b in zip(checkpoint.flatten(got)[0], checkpoint.flatten(ref)[0]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
