"""Port parity: xLSTM (``models/xlstm.py``) against the JAX package's, on
the JAX package's tiny xlstm-1.3b parameters carried across by
``interop.params_from_jax`` (its decode states by ``cache_from_jax``),
with inputs made with numpy from a seed.

``mlstm_chunkwise`` at lengths that pad the last chunk, fill it, span
several chunks, and S = 1; ``slstm_seq`` (associative scans here, a serial
scan there); the step forms
(``mlstm_step``, ``slstm_step``) against the JAX package's and against
the port's own sequence forms, token by token; ``forward`` in f32 and
bf16; ``decode_step`` against the JAX package's from the same states;
the decode state's constant size (the JAX package's
``test_ssm_constant_state_decode``); the layout and decay ranks; one
AdamW step of ``make_train_step``.

Tolerances: f32 1e-5 of the largest magnitude compared (sums in another
order; the exponential gates, ``exp`` of differences of cumulative
log-sigmoids, stay within it on these inputs, so the 1e-4 they might
need is not taken); bf16 0.05 × max(1, |ref|).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import api, xlstm  # noqa: E402

F32_TOL = 1e-5
BF16_REL = 0.05
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _model(dtype="float32", n_layers=None):
    kw = {"dtype": dtype}
    if n_layers:
        kw["n_layers"] = n_layers
    jcfg = dataclasses.replace(jconfigs.tiny(jconfigs.get("xlstm-1.3b")), **kw)
    cfg = dataclasses.replace(configs.tiny(configs.get("xlstm-1.3b")), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device=CPU)
    return jcfg, cfg, jparams, params


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _within(got, want, tol):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * max(1.0, float(np.abs(w).max())), err


def _block(kind):
    """(JAX block params, port block params) of the first block of
    ``kind`` (the tiny pattern is (mlstm, slstm), two cycles), with a
    forget bias spread over heads so the gates differ."""
    jcfg, cfg, jparams, params = _model()
    i = xlstm.block_types(cfg).index(kind)
    jp = jax.tree.map(lambda a: a[0], jparams["cycles"][str(i)])
    p = dict(params["blocks"][i])
    bf = np.random.default_rng(7).uniform(-2, 4, p["bf"].shape).astype(np.float32)
    return jcfg, cfg, dict(jp, bf=jnp.asarray(bf)), dict(p, bf=torch.tensor(bf))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("S", [1, 7, 16, 20, 48], ids=lambda s: f"S{s}")
def test_mlstm_chunkwise_matches_jax(S):
    """chunk = 16: S = 7 and 20 pad the last chunk, 48 spans three."""
    jcfg, cfg, jp, p = _block("mlstm")
    assert cfg.chunk == 16
    x = _x((2, S, 64), S)
    want = jxlstm.mlstm_chunkwise(jp, jnp.asarray(x), jcfg)
    got = xlstm.mlstm_chunkwise(p, torch.tensor(x), cfg)
    assert got.shape == (2, S, 64)
    _within(got, want, F32_TOL)


@pytest.mark.parametrize("S", [1, 2, 20, 333])
def test_slstm_seq_matches_jax(S):
    """The two associative scans (even, odd and long S) against the JAX
    package's serial scan."""
    jcfg, cfg, jp, p = _block("slstm")
    x = _x((2, S, 64), 30 + S)
    want = jxlstm.slstm_seq(jp, jnp.asarray(x), jcfg)
    got = xlstm.slstm_seq(p, torch.tensor(x), cfg)
    _within(got, want, F32_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_steps_match_jax_and_the_sequence_form(kind):
    """Ten steps from the zero state against the JAX package's steps (the
    states compared after each), and the outputs against the port's own
    sequence form over the same ten tokens."""
    jcfg, cfg, jp, p = _block(kind)
    x = _x((2, 10, 64), 40)
    jstep = jxlstm.mlstm_step if kind == "mlstm" else jxlstm.slstm_step
    step = xlstm.mlstm_step if kind == "mlstm" else xlstm.slstm_step
    seq = xlstm.mlstm_chunkwise if kind == "mlstm" else xlstm.slstm_seq
    jstate = jxlstm._block_state(jcfg, kind, 2)
    state = xlstm._block_state(cfg, kind, 2, CPU)
    for a, b in zip(state, jstate):
        np.testing.assert_array_equal(_np(a), _np(b))
    outs = []
    for t in range(10):
        wy, jstate = jstep(jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
        gy, state = step(p, torch.tensor(x[:, t:t + 1]), state, cfg)
        _within(gy, wy, F32_TOL)
        for a, b in zip(state, jstate):
            _within(a, b, F32_TOL)
        outs.append(gy)
    _within(torch.cat(outs, dim=1), seq(p, torch.tensor(x), cfg), F32_TOL)


@pytest.mark.parametrize("dtype,n_layers,remat", [
    ("float32", None, True), ("float32", 5, False), ("bfloat16", None, False)],
    ids=["f32-remat", "f32-tail", "bf16"])
def test_forward_matches_jax(dtype, n_layers, remat):
    """Two full cycles (each under remat where asked), and 5 layers: two
    cycles and an mLSTM tail."""
    jcfg, cfg, jparams, params = _model(dtype, n_layers)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    cfg = dataclasses.replace(cfg, remat=remat)
    toks = np.random.default_rng(8).integers(0, 256, (2, 21)).astype(np.int32)
    want, waux = jxlstm.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = xlstm.forward(params, torch.tensor(toks), cfg)
    assert got.dtype == getattr(torch, dtype) and float(aux) == float(waux) == 0
    _within(got, want, F32_TOL if dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("n_layers", [None, 5], ids=["tiny", "tail"])
def test_decode_steps_match_jax(n_layers):
    jcfg, cfg, jparams, params = _model("float32", n_layers)
    jcache = japi.init_cache(jcfg, 2, 0)
    cache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), cfg,
                                   device=CPU)
    jstep = jax.jit(functools.partial(japi.decode_step, jcfg))
    toks = np.random.default_rng(9).integers(0, 256, (12, 2, 1))
    for s in range(12):
        wl, jcache = jstep(jparams, jcache, jnp.asarray(toks[s], jnp.int32))
        gl, cache = api.decode_step(cfg, params, cache,
                                    torch.tensor(toks[s], dtype=torch.int32))
        _within(gl, wl, F32_TOL)
        want = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), cfg,
                                      device=CPU)
        assert cache["pos"] == want["pos"] == s + 1
        for a, b in zip(cache["blocks"], want["blocks"]):
            for x, y in zip(a, b):
                _within(x, y, F32_TOL)


def test_decode_state_has_a_constant_size():
    _, cfg, _, params = _model()
    assert api.decode_cache_len(cfg, 10 ** 6) == 0
    cache = api.init_cache(cfg, 1, 0, device=CPU)

    def size(c):
        return sum(t.numel() for b in c["blocks"] for t in b)
    n = size(cache)
    for t in range(3):
        _, cache = api.decode_step(cfg, params, cache,
                                   torch.zeros((1, 1), dtype=torch.int32))
        assert size(cache) == n
    full = configs.get("xlstm-1.3b")
    c = api.init_cache(full, 1, 0, device="meta")
    # per layer: mLSTM C, n, m of 4 heads of 512; sLSTM c, n, m
    assert size(c) == 42 * 4 * (512 * 512 + 512 + 1) + 6 * 3 * 4 * 512


def test_layout_and_decay_ranks():
    """Layers in order from the JAX package's two stacked cycles and a
    tail; a full cycle's leaves decay by their stacked rank."""
    jcfg, cfg, jparams, params = _model("float32", 5)
    assert xlstm.block_types(cfg) == jxlstm.block_types(jcfg) == \
        ["mlstm", "slstm", "mlstm", "slstm", "mlstm"]
    assert xlstm._cycle_split(cfg) == jxlstm._cycle_split(jcfg) == (2, 1)
    np.testing.assert_array_equal(
        params["blocks"][3]["wz"].numpy(),
        np.asarray(jparams["cycles"]["1"]["wz"][1]))
    np.testing.assert_array_equal(params["blocks"][4]["wq"].numpy(),
                                  np.asarray(jparams["tail"][0]["wq"]))
    nd = api.stacked_ndims(cfg, params)
    assert nd["blocks"][1]["bf"] == 3 and nd["blocks"][3]["ln"]["scale"] == 2
    assert nd["blocks"][4]["bf"] == 1 and nd["blocks"][4]["wq"] == 3


def _train_step_matches_jax(jcfg, cfg, batch):
    """One AdamW step of ``make_train_step`` against the JAX package's from
    the same train state: the metrics and moments to 1e-5; each param to
    lr times the update's slope on a 1e-5 gradient difference (as in
    ``test_torch_train.py``), every leaf moved."""
    from repro.train import optimizer as jopt
    from repro.train import train_loop as jtl
    from repro_torch.train import optimizer, train_loop
    c = dict(warmup_steps=0, total_steps=10)
    jstate = jtl.init_state(jcfg, jax.random.PRNGKey(0))
    state = interop.state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                   device=CPU)
    before = optimizer.tree_leaves(interop.state_from_jax(
        jax.tree.map(np.asarray, jstate), cfg, device=CPU)["params"])
    jstate, jm = jax.jit(jtl.make_train_step(
        jcfg, jtl.TrainConfig(opt=jopt.OptConfig(**c))))(
            jstate, jax.tree.map(jnp.asarray, batch))
    state, m = train_loop.make_train_step(
        cfg, train_loop.TrainConfig(opt=optimizer.OptConfig(**c)))(state, batch)
    want = interop.state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                  device=CPU)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=F32_TOL)
    for part in ("m", "v"):
        for a, b in zip(optimizer.tree_leaves(state["opt"][part]),
                        optimizer.tree_leaves(want["opt"][part])):
            _within(a, b, F32_TOL)
    lr, eps = float(jm["lr"]), optimizer.OptConfig().eps
    for p, wp, wm, p0 in zip(optimizer.tree_leaves(state["params"]),
                             optimizer.tree_leaves(want["params"]),
                             optimizer.tree_leaves(want["opt"]["m"]), before):
        assert not torch.equal(p, p0)
        g = wm.abs() / 0.1                            # |g| = |m| / (1 - b1)
        slope = eps / (g + eps) ** 2
        tol = lr * torch.clamp(F32_TOL * float(g.max()) * slope, max=2.0) \
            + 1e-6 * wp.abs()
        assert bool(((p - wp).abs() <= tol + 1e-9).all())


def test_train_step_matches_jax():
    jcfg, cfg, _, _ = _model()
    toks = np.random.default_rng(10).integers(0, 256, (2, 21)).astype(np.int32)
    _train_step_matches_jax(jcfg, cfg, {"tokens": toks[:, :-1],
                                        "labels": toks[:, 1:]})
