"""Port parity: the training path (``train/optimizer``, ``train/data``,
``train/train_loop``, ``models/api.loss_fn``, ``launch/train``) against
the JAX package, on the JAX package's tiny RecurrentGemma parameters and
train state carried across by ``interop.params_from_jax`` /
``state_from_jax``, with inputs made with numpy from a seed.

Tolerances:

* f32: 1e-5 of the largest magnitude compared (sums in another order;
  the RG-LRU scan combines in the same order as ``lax.associative_scan``).
* bf16: the loss to 3e-2 of itself; every gradient leaf to 5e-2 of its
  largest magnitude.  The two frameworks round at other places (XLA fuses
  elementwise chains, PyTorch rounds each op; K6 adds in f32), and bf16
  gradients carry that through every layer: the JAX package's own bf16
  gradients sit up to 3.8 % of a leaf's maximum from its f32 gradients on
  these inputs, the port's up to 4.0 % from JAX's bf16 ones.
* The params after one AdamW step: the update of an element is
  u = g / (|g| + eps) at the first step, whose slope eps / (|g| + eps)^2
  turns a gradient difference of 1e-5 of the leaf's largest gradient into
  an update difference of up to lr where |g| is near eps; each element is
  held to lr times that propagated difference plus 1e-6 of the param.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jtl  # noqa: E402
from repro_torch import configs, interop, sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.train import checkpoint, data, optimizer, train_loop  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402

F32_TOL = 1e-5
BF16_LOSS = 3e-2
BF16_GRAD = 5e-2
CPU = "cpu"


def _cfgs(dtype="float32", **kw):
    j = dataclasses.replace(jconfigs.tiny(jconfigs.get("recurrentgemma-9b")),
                            dtype=dtype, **kw)
    t = dataclasses.replace(configs.tiny(configs.get("recurrentgemma-9b")),
                            dtype=dtype, **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


def _close_leaves(got, want, rel):
    """Every leaf of ``got`` within ``rel`` of its largest magnitude in
    ``want`` (trees in the port's layout)."""
    want = dict(_paths(want))
    n = 0
    for name, a in _paths(got):
        b = want[name]
        assert tuple(a.shape) == tuple(b.shape), name
        scale = max(float(np.abs(_np(b)).max()), 1e-30)
        err = float(np.abs(_np(a) - _np(b)).max())
        assert err <= rel * scale, (name, err, scale)
        n += 1
    assert n == len(want)


def _batch(B=2, S=24, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(dtype, logits_chunk=256, n_layers=None, grad=True):
    """(port config, port params, batch, JAX loss, JAX gradient in the
    port's layout or None) of the tiny config from ``PRNGKey(0)``."""
    kw = {"logits_chunk": logits_chunk}
    if n_layers:
        kw["n_layers"] = n_layers
    jcfg, cfg = _cfgs(dtype, **kw)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch()
    jb = jax.tree.map(jnp.asarray, batch)
    params = interop.params_from_jax(_tree_np(jparams), cfg, device=CPU)
    if not grad:
        loss, _ = jax.jit(functools.partial(japi.loss_fn, jcfg))(jparams, jb)
        return cfg, params, batch, float(loss), None
    (loss, _), grads = jax.jit(jax.value_and_grad(
        functools.partial(japi.loss_fn, jcfg), has_aux=True))(jparams, jb)
    return cfg, params, batch, float(loss), \
        interop.params_from_jax(_tree_np(grads), cfg, device=CPU)


# -- optimizer ----------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 100)])
def test_schedule_matches_jax(warmup, total):
    c = optimizer.OptConfig(warmup_steps=warmup, total_steps=total)
    jc = jopt.OptConfig(warmup_steps=warmup, total_steps=total)
    steps = sorted({0, 1, warmup // 2, warmup, warmup + 1, total // 2,
                    total - 1, total, total + 7})
    got = [float(optimizer.schedule(c, s)) for s in steps]
    want = [float(jopt.schedule(jc, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_global_norm_clip_and_empty_tree():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32) * 10,
                  rng.standard_normal((2, 2, 2)).astype(np.float32)]}
    ttree = tree_map(torch.tensor, tree)
    np.testing.assert_allclose(float(optimizer.global_norm(ttree)),
                               float(jopt.global_norm(tree)), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        got, n = optimizer.clip_by_global_norm(ttree, max_norm)
        want, wn = jopt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        np.testing.assert_allclose(float(n), float(wn), rtol=1e-6)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    for empty in ({}, [], {"x": []}):
        assert float(optimizer.global_norm(empty)) == 0.0 == \
            float(jopt.global_norm(empty))


def _apply_both(params_np, grads_np, c, jc, step, cfg=None):
    """One ``apply`` in both packages from the same numpy trees; returns
    (port params, m, v), (JAX params, m, v), both in the port's layout."""
    to_t = (lambda t: interop.params_from_jax(t, cfg, device=CPU)) \
        if cfg is not None else (lambda t: tree_map(torch.tensor, t))
    params, grads = to_t(params_np), to_t(grads_np)
    opt = optimizer.init(params)
    ndims = api.stacked_ndims(cfg, params) if cfg is not None else None
    p2, o2, _ = optimizer.apply(c, params, grads, opt, step, ndims=ndims)
    jp, jg = jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray,
                                                               grads_np)
    jp2, jo2, _ = jax.jit(functools.partial(jopt.apply, jc))(
        jp, jg, jopt.init(jp), jnp.int32(step))
    back = (lambda t: to_t(_tree_np(t)))
    return (p2, o2["m"], o2["v"]), (back(jp2), back(jo2["m"]), back(jo2["v"]))


def test_bare_array_is_never_decayed():
    """A bare array as the whole params (a physical field) takes no weight
    decay, in either package; the same array inside a tree does."""
    rng = np.random.default_rng(2)
    p = rng.standard_normal((6, 7)).astype(np.float32)
    g = rng.standard_normal((6, 7)).astype(np.float32)
    c = optimizer.OptConfig(warmup_steps=0, weight_decay=0.5)
    jc = jopt.OptConfig(warmup_steps=0, weight_decay=0.5)
    got, want = _apply_both(p, g, c, jc, 3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    nodecay, _ = _apply_both(p, g, dataclasses.replace(c, weight_decay=0.0),
                             dataclasses.replace(jc, weight_decay=0.0), 3)
    assert torch.equal(got[0], nodecay[0])
    tree, _ = _apply_both({"w": p}, {"w": g}, c, jc, 3)
    assert not torch.equal(tree[0]["w"], got[0])


def test_stacked_leaf_decay_rule():
    """JAX stacks the full cycles' leaves on a leading axis, so every leaf
    of a full cycle (norm scales, biases, ``lam``, ``conv_b``) has rank
    ≥ 2 there and is decayed, while a tail block's vectors are not: the
    port decays by that rank (``api.stacked_ndims``)."""
    jcfg, cfg = _cfgs(n_layers=8)              # two full cycles + (rec, rec)
    jparams = _tree_np(japi.init_params(jcfg, jax.random.PRNGKey(3)))
    params = interop.params_from_jax(jparams, cfg, device=CPU)
    ndims = api.stacked_ndims(cfg, params)
    for i, b in enumerate(ndims["blocks"]):
        for name, nd in _paths(b):
            own = dict(_paths(params["blocks"][i]))[name].dim()
            assert nd == own + (1 if i < 6 else 0), (i, name)
    assert ndims["final_norm"]["scale"] == 1
    assert ndims["embed"]["tok"] == 2
    # zero gradients: the update is the decay alone
    grads = jax.tree.map(np.zeros_like, jparams)
    c = optimizer.OptConfig(warmup_steps=0, weight_decay=0.5)
    jc = jopt.OptConfig(warmup_steps=0, weight_decay=0.5)
    got, want = _apply_both(jparams, grads, c, jc, 0, cfg=cfg)
    for a, b in zip(got, want):
        _close_leaves(a, b, 1e-6)
    before = dict(_paths(params))
    moved = {n for n, t in _paths(got[0]) if not torch.equal(t, before[n])}
    assert "/blocks/0/mix/lam" in moved and "/blocks/5/ffn/ln/scale" in moved
    assert "/blocks/6/mix/lam" not in moved
    assert "/blocks/7/mix/conv_b" not in moved
    assert "/final_norm/scale" not in moved and "/embed/tok" in moved


def test_apply_matches_jax_on_the_same_gradients():
    jcfg, cfg = _cfgs(n_layers=8)
    jparams = _tree_np(japi.init_params(jcfg, jax.random.PRNGKey(4)))
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.1,
        jparams)
    c, jc = optimizer.OptConfig(warmup_steps=2), jopt.OptConfig(warmup_steps=2)
    got, want = _apply_both(jparams, grads, c, jc, 5, cfg=cfg)
    for a, b in zip(got, want):
        _close_leaves(a, b, 1e-6)


# -- data -----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
def test_data_batches_bit_equal(seed):
    cfg = configs.tiny(configs.get("recurrentgemma-9b"))
    jcfg = jconfigs.tiny(jconfigs.get("recurrentgemma-9b"))
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=3)
    jshape = dataclasses.replace(JSHAPES["train_4k"], seq_len=32,
                                 global_batch=3)
    fn = data.make_batch_fn(cfg, shape, seed=seed)
    jfn = jdata.make_batch_fn(jcfg, jshape, seed=seed)
    for step in (0, 1, 5):
        got, want = fn(step), jfn(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


# -- loss and gradients -----------------------------------------------------
@pytest.mark.parametrize("dtype,logits_chunk", [
    ("float32", 256), ("float32", 8), ("float32", None), ("bfloat16", 256)],
    ids=["f32-chunk256", "f32-chunk8-ragged", "f32-unchunked", "bf16-chunk256"])
def test_loss_fn_matches_jax(dtype, logits_chunk):
    cfg, params, batch, want, _ = _jax_loss_and_grad(
        dtype, logits_chunk, None, logits_chunk == 256)
    loss, metrics = api.loss_fn(cfg, params, tree_map(torch.tensor, batch))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(metrics["aux"]) == 0.0
    tol = F32_TOL if dtype == "float32" else BF16_LOSS
    assert abs(float(loss) - want) <= tol * abs(want), (float(loss), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_gradient_leaf_matches_jax_grad(dtype):
    cfg, params, batch, want_loss, want = _jax_loss_and_grad(dtype, 256,
                                                             None, True)
    loss, grads = train_loop.make_loss_and_grad(cfg)(
        params, tree_map(torch.tensor, batch))
    tol = F32_TOL if dtype == "float32" else BF16_GRAD
    assert abs(float(loss) - want_loss) <= \
        (F32_TOL if dtype == "float32" else BF16_LOSS) * abs(want_loss)
    for name, g in _paths(grads):
        assert g.dtype == torch.float32, name     # f32 master params
    _close_leaves(grads, want, tol)


def test_gradients_with_a_tail_match_jax():
    """8 layers: two full cycles (checkpointed) and a (rec, rec) tail."""
    cfg, params, batch, _, want = _jax_loss_and_grad("float32", 256, 8, True)
    cfg = dataclasses.replace(cfg, remat=True)
    _, grads = train_loop.make_loss_and_grad(cfg)(
        params, tree_map(torch.tensor, batch))
    _close_leaves(grads, want, F32_TOL)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(policy):
    """Checkpointed cycles recompute the same values: equal gradients."""
    cfg, params, batch, _, _ = _jax_loss_and_grad("float32", 256, None, True)
    tb = tree_map(torch.tensor, batch)
    _, want = train_loop.make_loss_and_grad(cfg)(params, tb)
    rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    _, got = train_loop.make_loss_and_grad(rcfg)(params, tb)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


# -- the train step -----------------------------------------------------------
def test_train_step_matches_jax():
    jcfg, cfg = _cfgs()
    c = dict(warmup_steps=0, total_steps=10)
    jstate = jtl.init_state(jcfg, jax.random.PRNGKey(0))
    state = interop.state_from_jax(_tree_np(jstate), cfg, device=CPU)
    before = interop.state_from_jax(_tree_np(jstate), cfg, device=CPU)
    batch = _batch(B=4, S=16, seed=1)
    jstep = jax.jit(jtl.make_train_step(
        jcfg, jtl.TrainConfig(opt=jopt.OptConfig(**c))))
    jstate2, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    state2, m = train_loop.make_train_step(
        cfg, train_loop.TrainConfig(opt=optimizer.OptConfig(**c)))(state, batch)
    want = interop.state_from_jax(_tree_np(jstate2), cfg, device=CPU)
    assert state2["step"] == want["step"] == 1
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=F32_TOL)
    _close_leaves(state2["opt"]["m"], want["opt"]["m"], F32_TOL)
    _close_leaves(state2["opt"]["v"], want["opt"]["v"], F32_TOL)
    lr, eps = float(jm["lr"]), optimizer.OptConfig().eps
    gmax = {n: float(t.abs().max()) / 0.1 for n, t in _paths(want["opt"]["m"])}
    wm = dict(_paths(want["opt"]["m"]))
    wp, p0 = dict(_paths(want["params"])), dict(_paths(before["params"]))
    for name, p in _paths(state2["params"]):
        assert not torch.equal(p, p0[name]), name          # every leaf moved
        g = wm[name].abs() / 0.1                           # |g| = |m| / (1 - b1)
        slope = eps / (g + eps) ** 2
        tol = lr * torch.clamp(F32_TOL * gmax[name] * slope, max=2.0) \
            + 1e-6 * wp[name].abs()
        assert bool(((p - wp[name]).abs() <= tol + 1e-9).all()), name


def test_microbatches_equal_the_full_batch():
    _, cfg = _cfgs()
    batch = _batch(B=4, S=16, seed=2)
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(warmup_steps=0))
    full = train_loop.init_state(cfg, device=CPU, seed=3)
    split = train_loop.init_state(cfg, device=CPU, seed=3)
    full, m1 = train_loop.make_train_step(cfg, tc)(full, batch)
    split, m2 = train_loop.make_train_step(
        cfg, dataclasses.replace(tc, n_microbatches=2))(split, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=F32_TOL)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=F32_TOL)
    _close_leaves(split["opt"]["m"], full["opt"]["m"], F32_TOL)
    _close_leaves(split["opt"]["v"], full["opt"]["v"], F32_TOL)
    assert split["step"] == full["step"] == 1


def test_split_microbatches():
    b = {"tokens": torch.arange(24).reshape(4, 6)}
    s = train_loop._split_microbatches(b, 2)
    assert tuple(s["tokens"].shape) == (2, 2, 6)
    assert torch.equal(s["tokens"][1], b["tokens"][2:])
    with pytest.raises(AssertionError):
        train_loop._split_microbatches(b, 3)


def test_state_from_jax_layout():
    jcfg, cfg = _cfgs()
    jstate = _tree_np(jtl.init_state(jcfg, jax.random.PRNGKey(0)))
    state = interop.state_from_jax(jstate, cfg, device=CPU)
    assert state["step"] == 0 and set(state["opt"]) == {"m", "v"}
    mine = train_loop.init_state(cfg, device=CPU)
    assert mine["step"] == 0
    for part in ("params", "opt"):
        got, want = dict(_paths(state[part])), dict(_paths(mine[part]))
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert tuple(t.shape) == tuple(want[name].shape), name


# -- the CLI and what is not ported ------------------------------------------
def test_launch_train_smoke_on_the_cpu(capsys):
    losses = train_cli.main(["--preset", "smoke", "--device", "cpu",
                             "--steps", "2"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: 2 steps" in out and "on cpu" in out


@pytest.mark.parametrize("argv", [["--preset", "full"],
                                  ["--ckpt-dir", "ckpt", "--device", "cpu"]],
                         ids=["full", "ckpt"])
def test_launch_train_not_ported_options(argv, tmp_path, capsys, monkeypatch):
    """Both options, once not ported, run: ``--preset full`` (the config
    ``configs.get`` gives, here the tiny one, on the production mesh of CPU
    shards) and ``--ckpt-dir``."""
    if "--ckpt-dir" not in argv:
        get = configs.get
        monkeypatch.setattr(train_cli.configs, "get",
                            lambda name: configs.tiny(get(name)))
        losses = train_cli.main(argv + ["--device", "cpu", "--arch",
                                        "phi3-mini-3.8b", "--global-batch", "16",
                                        "--seq-len", "8", "--steps", "2"])
        out = capsys.readouterr().out
        assert len(losses) == 2 and all(np.isfinite(losses))
        assert "{'data': 16, 'model': 16}" in out
        # the first loss is the unsharded step's on the same state and batch
        cfg = configs.tiny(configs.get("phi3-mini-3.8b"))
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=8, global_batch=16)
        _, m = train_loop.make_train_step(cfg, train_loop.TrainConfig())(
            train_loop.init_state(cfg, device=CPU, seed=0),
            data.make_batch_fn(cfg, shape, seed=0)(0))
        np.testing.assert_allclose(losses[0], float(m["loss"]), rtol=F32_TOL)
        return
    # --ckpt-dir is ported: two steps with a checkpoint after each, then a
    # second run on the same directory resumes after step 2
    ckpt = str(tmp_path / "ckpt")
    args = ["--ckpt-dir", ckpt, "--device", "cpu", "--ckpt-every", "1", "--seq-len", "16",
            "--global-batch", "2"]
    losses = train_cli.main(args + ["--steps", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert checkpoint.steps(ckpt) == [1, 2]
    more = train_cli.main(args + ["--steps", "3"])
    assert len(more) == 1 and np.isfinite(more[0])
    assert checkpoint.steps(ckpt) == [1, 2, 3]
    assert "step     2" in capsys.readouterr().out


def test_sharded_step_is_not_ported():
    """Once not ported, the sharded step runs: ``state_shardings`` and
    ``compile_train_step`` on a (2, 2) CPU mesh, one step of the tiny
    Griffin, then of the tiny MoE, to the unsharded step's loss."""
    _, cfg = _cfgs()
    mesh = make_mesh((2, 2), ("data", "model"), devices=[CPU])
    shard = train_loop.state_shardings(cfg, mesh)
    state = sharding.device_put(train_loop.init_state(cfg, device=CPU, seed=3),
                                shard)
    batch = _batch(B=4, S=16, seed=4)
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(warmup_steps=0))
    plan, step = train_loop.compile_train_step(cfg, tc, mesh, batch)
    assert plan.in_shardings[0] is shard or plan.in_shardings[0] == shard
    state, m = step(state, batch)
    _, want = train_loop.make_train_step(cfg, tc)(
        train_loop.init_state(cfg, device=CPU, seed=3), batch)
    assert state["step"] == 1
    np.testing.assert_allclose(float(m["loss"]), float(want["loss"]), rtol=F32_TOL)
    moe = configs.tiny(configs.get("mixtral-8x7b"))
    _, step = train_loop.compile_train_step(moe, tc, mesh, batch)
    _, m = step(sharding.device_put(train_loop.init_state(moe, device=CPU, seed=3),
                                    train_loop.state_shardings(moe, mesh)), batch)
    _, want = train_loop.make_train_step(moe, tc)(
        train_loop.init_state(moe, device=CPU, seed=3), batch)
    np.testing.assert_allclose(float(m["loss"]), float(want["loss"]), rtol=F32_TOL)


def test_training_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop.init_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--steps", "1"])


# -- gradient compression -----------------------------------------------------------
def test_int8_compression_matches_jax():
    """``compress_int8``'s ``q`` and ``scale`` bit for bit the JAX
    package's on the same numpy input (ties of round-half-even included),
    and the round trip within one step of the scale."""
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((64, 64)).astype(np.float32),
         "b": np.array([0.5, -1.5, 2.5, 127.0, -127.0, 0.0], np.float32),
         "z": np.zeros((3,), np.float32)}
    got = optimizer.compress_int8(tree_map(torch.tensor, g))
    want = jopt.compress_int8(jax.tree.map(jnp.asarray, g))
    for k in g:
        assert got[k]["q"].dtype == torch.int8
        np.testing.assert_array_equal(got[k]["q"].numpy(), np.asarray(want[k]["q"]))
        assert np.float32(got[k]["scale"]) == np.float32(want[k]["scale"])
    back = optimizer.decompress_int8(got)
    want_back = jopt.decompress_int8(want)
    for k in g:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want_back[k]))
    err = float((back["w"] - torch.tensor(g["w"])).abs().max())
    assert err <= float(np.abs(g["w"]).max()) / 127.0 + 1e-6


def test_int8_compression_is_convergence_neutral():
    """The JAX package's check on the port: 20 steps of the tiny granite
    with int8-compressed gradients reach a loss within 5% of exact-gradient
    training (lr 1e-3, warmup 5, batch 8 x 32)."""
    cfg = dataclasses.replace(configs.tiny(configs.get("granite-8b")))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=8)
    batch_fn = data.make_batch_fn(cfg, shape, seed=0)
    oc = optimizer.OptConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    grad_fn = train_loop.make_loss_and_grad(cfg)

    def run(compress):
        state = train_loop.init_state(cfg, device=CPU, seed=0)
        for s in range(20):
            b = {k: torch.as_tensor(v) for k, v in batch_fn(s).items()}
            loss, g = grad_fn(state["params"], b)
            if compress:
                g = optimizer.decompress_int8(optimizer.compress_int8(g))
            optimizer.apply(oc, state["params"], g, state["opt"], state["step"],
                            ndims=api.stacked_ndims(cfg, state["params"]))
            state["step"] += 1
        return float(loss)

    exact, comp = run(False), run(True)
    assert abs(comp - exact) / abs(exact) < 0.05, (exact, comp)
