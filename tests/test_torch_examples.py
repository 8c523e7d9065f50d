"""The port's examples (``examples/torch_port/``) held against the JAX
package on the CPU, on the same numpy inputs.

- quickstart: the per-step fields (``st.torch()`` and ``st.hopper``'s
  plain versions) and the fused ones against the JAX package's
  ``st.launch(st.xla())`` of the same target from the same
  ``randomize(0)``, at 256² × 50 steps: 1e-6 of max(1, |field|) (the JAX
  script's own fused-vs-per-step bound; measured 1.6e-7).
- fwi --smoke (n = 16, 20 steps): the first misfit against JAX's
  ``jax.value_and_grad(misfit)`` (rel 1e-5) and its gradient (5e-4 of its
  max: both f32 gradients sit 1.0e-4 (JAX) and 2.6e-4 (port) of the max
  from the f64 one, the problem's own f32 rounding; in f64 the two agree
  within 1e-10 of the max); the eight-iteration misfit trajectory against
  JAX's jitted loop (rel 2e-5) and the final model (1e-4 of its max);
  ``--mesh 4`` on CPU shards against the unsharded port (misfits rel
  1e-5, model 1e-6 of its max).
- serve_lm: the greedy tokens of all five demos equal the JAX package's,
  parameters carried across by ``interop.params_from_jax``, in f32 (in
  bf16 the two packages round differently and xLSTM's tokens part).
- train_lm --preset smoke: the first three losses against JAX's
  ``make_train_step`` from a state carried across by
  ``interop.state_from_jax``, in f32, rel 1e-5; a ``--ckpt-dir`` run and
  a run resumed from its checkpoint give the uninterrupted run's losses
  bit for bit.
- every script's ``main(["--device", "cpu", ...])`` runs to ``OK``;
  without a card, ``main([])`` raises.
"""
import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs.shapes import ShapeSpec as JShapeSpec  # noqa: E402
from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import serve_loop as jserve  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jtl  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "examples" / "torch_port"
NAMES = ("quickstart", "acoustic_iso_3d", "fwi", "serve_lm", "train_lm")


@functools.lru_cache(maxsize=None)
def example(name: str, where: pathlib.Path = PORT):
    """The example script ``name`` as a module (the port's, or with
    ``where=REPO / "examples"`` the JAX package's)."""
    tag = "torch_port" if where == PORT else "jax"
    spec = importlib.util.spec_from_file_location(f"_{tag}_{name}",
                                                  where / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# ---- quickstart ---------------------------------------------------------------
def test_quickstart_fields_match_jax_xla():
    q, jq = example("quickstart"), example("quickstart", REPO / "examples")
    u = jst.grid(dtype=jst.f32, shape=q.SHAPE, order=4).randomize(0)
    v = jst.grid(dtype=jst.f32, shape=q.SHAPE, order=4)
    jst.launch(backend=jst.xla())(jq.target_star2d4r)(u, v, q.ITERS)
    want = np.asarray(u.interior)
    scale = max(1.0, float(np.abs(want).max()))
    runs = {"torch": q.per_step(st.torch(), "cpu"),
            "hopper": q.per_step(st.hopper(block=(8, 128)), "cpu"),
            "fused torch": q.fused(st.torch(), "cpu"),
            "fused hopper": q.fused(st.hopper(), "cpu")}
    for name, (got, _) in runs.items():
        err = float(np.abs(_np(got) - want).max())
        assert err <= 1e-6 * scale, (name, err, scale)
    assert runs["fused hopper"][1].steps == q.ITERS


# ---- fwi ----------------------------------------------------------------------
@jst.kernel
def _jwave2d(p0: jst.grid, p1: jst.grid, vp2: jst.grid, dt: jst.f32):
    lap = (p1.at(-1, 0) + p1.at(1, 0) + p1.at(0, -1) + p1.at(0, 1)
           - 4.0 * p1.at(0, 0))
    p0.at(0, 0).set(2.0 * p1.at(0, 0) - p0.at(0, 0)
                    + vp2.at(0, 0) * dt * dt * lap)


def _jax_misfit(n, steps, dtype=jnp.float32):
    """The JAX script's propagator and misfit (``examples/fwi.py``)."""
    f = example("fwi")
    src = (2, n // 2)

    def between(t, grids):
        g = grids["p1"]
        idx = (g.order + src[0], g.order + src[1])
        g.data = g.data.at[idx].add(
            jacoustic.source_wavelet(t, f0=0.06, t0=10))
    gs = [jst.grid(dtype, (n, n), order=1) for _ in range(3)]
    gs[2].interior = f.true_model(n).astype(dtype)
    fwd = jst.differentiable_timeloop(_jwave2d, *gs, np.float32(f.DT),
                                      steps=steps, swap=("p0", "p1"),
                                      fuse_steps=1, between=between)
    obs = fwd()
    d_obs = {g: obs[g] for g in ("p0", "p1")}

    def misfit(v):
        arrays = dict(fwd.arrays)
        arrays["vp2"] = arrays["vp2"].at[1:-1, 1:-1].set(v)
        out = fwd(arrays, fwd.scalars)
        return 0.5 * sum(jnp.sum((out[g] - d_obs[g]) ** 2)
                         for g in ("p0", "p1"))
    return misfit


def _port_grad(n, steps, dtype=st.f32, backend=None):
    f = example("fwi")
    _, _, misfit = f.make_problem(n, steps, "cpu", backend, dtype=dtype)
    v = torch.full((n, n), 1.0, dtype=dtype.dtype).requires_grad_(True)
    loss = misfit(v)
    (g,) = torch.autograd.grad(loss, v)
    return float(loss.detach()), _np(g)


@pytest.mark.parametrize("backend", ["torch", "gmem"])
def test_fwi_first_misfit_and_gradient_match_jax(backend):
    be = st.torch() if backend == "torch" else st.hopper(template=backend)
    loss, grad = _port_grad(16, 20, backend=be)
    jloss, jgrad = jax.value_and_grad(_jax_misfit(16, 20))(
        jnp.full((16, 16), 1.0, jnp.float32))
    jgrad = np.asarray(jgrad)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert np.abs(grad - jgrad).max() <= 5e-4 * np.abs(jgrad).max()


def test_fwi_gradient_matches_jax_in_f64():
    loss, grad = _port_grad(16, 20, dtype=st.f64)
    with jax.enable_x64(True):
        jloss, jgrad = jax.value_and_grad(_jax_misfit(16, 20, jnp.float64))(
            jnp.full((16, 16), 1.0, jnp.float64))
        jloss, jgrad = float(jloss), np.asarray(jgrad)
    assert abs(loss - jloss) <= 1e-10 * abs(jloss)
    assert np.abs(grad - jgrad).max() <= 1e-10 * np.abs(jgrad).max()


@functools.lru_cache(maxsize=None)
def _fwi_smoke(*extra):
    return example("fwi").main(["--device", "cpu", "--smoke", *extra])


def test_fwi_smoke_trajectory_matches_jax():
    n, iters = 16, 8
    misfit = _jax_misfit(n, 20)
    cfg = jopt.OptConfig(lr=0.03, warmup_steps=5, total_steps=iters,
                         min_lr_ratio=0.3, weight_decay=0.1, clip_norm=10.0)

    @jax.jit
    def update(params, state, step):
        loss, g = jax.value_and_grad(misfit)(params)
        params, state, _ = jopt.apply(cfg, params, g, state, step)
        return params, state, loss
    params = jnp.full((n, n), 1.0, jnp.float32)
    state, want = jopt.init(params), []
    for i in range(iters):
        params, state, loss = update(params, state, jnp.int32(i))
        want.append(float(loss))
    got = _fwi_smoke()
    np.testing.assert_allclose(got["losses"], want, rtol=2e-5)
    params = np.asarray(params)
    assert np.abs(_np(got["params"]) - params).max() <= 1e-4 * np.abs(params).max()


def test_fwi_smoke_on_a_mesh_of_four_matches_the_unsharded_port():
    one, four = _fwi_smoke(), _fwi_smoke("--mesh", "4")
    np.testing.assert_allclose(four["losses"], one["losses"], rtol=1e-5)
    p = _np(one["params"])
    assert np.abs(_np(four["params"]) - p).max() <= 1e-6 * np.abs(p).max()
    assert four["losses"][-1] < four["losses"][0]


# ---- serve_lm ------------------------------------------------------------------
def _lm_params(name):
    jcfg = dataclasses.replace(jconfigs.tiny(jconfigs.get(name)), dtype="float32")
    cfg = dataclasses.replace(configs.tiny(configs.get(name)), dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("name", ["granite-8b", "mixtral-8x7b", "xlstm-1.3b",
                                  "recurrentgemma-9b"])
def test_serve_lm_decoder_demo_tokens_match_jax(name):
    s = example("serve_lm")
    jcfg, cfg, jparams, params = _lm_params(name)
    rng = np.random.default_rng(0)               # the JAX script's demo
    server = jserve.BatchServer(jcfg, jparams, batch_size=4,
                                gen=jserve.GenConfig(max_new_tokens=8))
    for _ in range(6):
        server.submit(rng.integers(0, jcfg.vocab, int(rng.integers(4, 12))), 8)
    want = {uid: r.result for uid, r in server.run_until_drained().items()}
    got = s.decoder_demo(name, cfg, params)
    assert got["requests"] == 6 and got["tokens"] == 48
    assert sorted(got["results"]) == sorted(want)
    for uid, toks in want.items():
        np.testing.assert_array_equal(got["results"][uid], toks)


def test_serve_lm_whisper_demo_tokens_match_jax():
    s = example("serve_lm")
    jcfg, cfg, jparams, params = _lm_params("whisper-small")
    rng = np.random.default_rng(0)
    gen = jserve.Generator(jcfg, jparams, jserve.GenConfig(max_new_tokens=8))
    prompts = rng.integers(0, jcfg.vocab, (2, 4)).astype(np.int32)
    frames = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    want = gen.generate(prompts, frame_embeds=frames)
    got = s.whisper_demo(cfg, params)
    assert got["shape"] == [2, 12]
    np.testing.assert_array_equal(got["tokens"], want)


# ---- train_lm ------------------------------------------------------------------
def test_train_lm_smoke_first_losses_match_jax():
    t = example("train_lm")
    cfg, _, shape = t.preset("smoke")
    cfg = dataclasses.replace(cfg, dtype="float32")
    jcfg = jbase.ModelConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)})
    jshape = JShapeSpec(shape.name, shape.kind, shape.seq_len, shape.global_batch)
    steps = 3
    jstate = jtl.init_state(jcfg, jax.random.PRNGKey(0))
    state = interop.state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    jtc = jtl.TrainConfig(opt=jopt.OptConfig(lr=3e-4, warmup_steps=20,
                                             total_steps=steps))
    jstep = jax.jit(jtl.make_train_step(jcfg, jtc))
    jbatch = jdata.make_batch_fn(jcfg, jshape, seed=0)
    want = []
    for s in range(steps):
        jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in jbatch(s).items()})
        want.append(float(m["loss"]))
    got = t.train(cfg, shape, steps, device="cpu", init_fn=lambda: state)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_train_lm_checkpointed_run_equals_the_uninterrupted_one(tmp_path):
    t = example("train_lm")
    cfg, _, shape = t.preset("smoke")
    dev = torch.device("cpu")
    want = t.train(cfg, shape, 6, device=dev)
    # the first call stops after 4 steps (checkpoints at 2 and 4); the
    # second resumes from step 4 in the same directory
    first = t.train(cfg, shape, 4, device=dev, ckpt_dir=str(tmp_path),
                    ckpt_every=2)
    rest = t.train(cfg, shape, 6, device=dev, ckpt_dir=str(tmp_path),
                   ckpt_every=2)
    assert first + rest == want
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == "step_00000006"


# ---- every script on the CPU, and the card by default -----------------------------
SMOKE_ARGS = {
    "quickstart": [],
    "acoustic_iso_3d": ["--shape", "32", "32", "32", "--iters", "8", "--pml", "6"],
    "acoustic_iso_3d --template gmem": ["--shape", "32", "32", "32", "--iters",
                                        "8", "--pml", "6", "--template", "gmem"],
    "acoustic_iso_3d --template shift --fuse 4": [
        "--shape", "32", "32", "32", "--iters", "8", "--pml", "6",
        "--template", "shift", "--fuse", "4"],
    "acoustic_iso_3d --distributed": ["--shape", "32", "32", "32", "--iters",
                                      "8", "--pml", "6", "--distributed"],
    "fwi": ["--smoke"],
    "fwi --template gmem": ["--smoke", "--template", "gmem"],
    "serve_lm": [],
    "train_lm": ["--steps", "12"],
    "train_lm --microbatches 2": ["--steps", "12", "--microbatches", "2"],
}


@pytest.mark.parametrize("case", list(SMOKE_ARGS))
def test_main_runs_to_ok_on_the_cpu(case, capsys):
    out = example(case.split()[0]).main(["--device", "cpu", *SMOKE_ARGS[case]])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1].startswith("OK"), printed[-3:]
    assert isinstance(out, dict) and out


def test_acoustic_distributed_equals_the_unsharded_run():
    a = example("acoustic_iso_3d")
    args = ["--device", "cpu", "--shape", "32", "32", "32", "--iters", "10",
            "--pml", "6"]
    for extra in ([], ["--fuse", "3"], ["--template", "gmem"]):
        one = a.main(args + extra)
        got = a.main(args + extra + ["--distributed"])
        assert got["energy"] == one["energy"], extra
        assert got["max_abs_p"] == one["max_abs_p"], extra
        assert torch.equal(got["field"], one["field"]), extra


@pytest.mark.parametrize("name", NAMES)
def test_main_needs_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main([])


def test_every_example_has_a_port_twin():
    jax_scripts = sorted(p.stem for p in (REPO / "examples").glob("*.py"))
    assert jax_scripts == sorted(NAMES)
    assert sorted(p.stem for p in PORT.glob("*.py")) == sorted(NAMES)
