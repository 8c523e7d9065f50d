"""Port parity: the sharded train step (``train_loop.compile_train_step``
on a (2, 2) mesh of CPU shards, ``models/sharded.py``) against the JAX
package's single-device ``make_train_step`` and against the port's own
unsharded step; elastic checkpoint restore; the families left out.

The JAX package's sharded path does not run on this machine's JAX (its
dry-run tests fail with a ``ShardingTypeError``), so the sharded step is
held to JAX's single-device step on the same state (``interop.state_from_
jax`` then ``sharding.device_put``) and batch.

Tolerances:

* against JAX, f32: ``test_torch_train.test_train_step_matches_jax``'s
  gates: loss, gradient norm and lr to ``F32_TOL`` = 1e-5 relative, the
  moments to 1e-5 of each leaf's largest magnitude, the params within the
  slope-aware bound of that test (the first AdamW update is g / (|g| +
  eps), whose slope near |g| ~ eps magnifies a gradient difference).
* against the port's unsharded step: the moments to 1e-6 of each leaf's
  largest magnitude, the params within the slope-aware bound at 1e-6, in
  f64 params and compute: in f32 the sharded sums' other order
  (row-parallel partials, the data groups' gradients) reads up to 1.7e-6
  of a leaf's maximum on these inputs (the RG-LRU gates' ``ba`` and
  ``lam``); in f64 up to 1.9e-7 (Griffin's gates compute in f32 in any
  run).
* replicas (a mesh on four distinct CPU devices ``cpu:0`` .. ``cpu:3``):
  every copy of a block bit for bit equal to its primary after the step.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jtl  # noqa: E402
from repro_torch import configs, interop, sharding  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import sharded  # noqa: E402
from repro_torch.train import checkpoint, fault_tolerance, optimizer, train_loop  # noqa: E402

F32_TOL = 1e-5
UNSHARDED_TOL = 1e-6
ARCHS = ("recurrentgemma-9b", "phi3-mini-3.8b", "granite-8b")
OPT = dict(warmup_steps=0, total_steps=10)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # many small operations a shard: oversubscribed cores under -n 6 slow
    # them more than one thread does
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    j = dataclasses.replace(jconfigs.tiny(jconfigs.get(arch)), dtype=dtype)
    t = dataclasses.replace(configs.tiny(configs.get(arch)), dtype=dtype)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _mesh(devices="one", shape=(2, 2)):
    devs = ["cpu"] if devices == "one" else \
        [torch.device("cpu", i) for i in range(int(np.prod(shape)))]
    return M.make_mesh(shape, ("data", "model"), devices=devs)


def _batch(B=4, S=16, seed=1, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


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
    want = dict(_paths(want))
    n = 0
    for name, a in _paths(got):
        b = want[name]
        scale = max(float(b.double().abs().max()), 1e-30)
        err = float((a.double() - b.double()).abs().max())
        assert err <= rel * scale, (name, err, scale)
        n += 1
    assert n == len(want)


def _params_close(got, want, want_m, lr, rel):
    """The params after the first AdamW step, each element within lr times
    the gradient difference ``rel`` of the leaf's largest gradient
    propagates through the update's slope eps / (|g| + eps)^2, plus 1e-6
    of the param (``test_train_step_matches_jax``'s bound)."""
    eps = optimizer.OptConfig().eps
    wm, wp = dict(_paths(want_m)), dict(_paths(want))
    for name, p in _paths(got):
        g = wm[name].double().abs() / 0.1                 # |g| = |m| / (1 - b1)
        slope = eps / (g + eps) ** 2
        tol = lr * torch.clamp(rel * float(g.max()) * slope, max=2.0) \
            + 1e-6 * wp[name].double().abs()
        assert bool(((p.double() - wp[name].double()).abs() <= tol + 1e-9).all()), name


def _placed(state, cfg, mesh):
    return sharding.device_put(state, train_loop.state_shardings(cfg, mesh))


@functools.lru_cache(maxsize=None)
def _jax_step(arch, n_mb):
    """(the JAX package's tiny state before and after one step of its
    single-device ``make_train_step``, as numpy trees, and its metrics)."""
    jcfg, _ = _cfgs(arch)
    jstate = jtl.init_state(jcfg, jax.random.PRNGKey(0))
    before = jax.tree.map(np.asarray, jstate)
    tc = jtl.TrainConfig(opt=jopt.OptConfig(**OPT), n_microbatches=n_mb)
    after, m = jax.jit(jtl.make_train_step(jcfg, tc))(
        jstate, jax.tree.map(jnp.asarray, _batch()))
    return before, jax.tree.map(np.asarray, after), {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("n_mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(arch, n_mb):
    _, cfg = _cfgs(arch)
    before, after, jm = _jax_step(arch, n_mb)
    mesh = _mesh()
    state = _placed(interop.state_from_jax(before, cfg, device="cpu"), cfg, mesh)
    p0 = interop.state_from_jax(before, cfg, device="cpu")["params"]
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(**OPT), n_microbatches=n_mb)
    batch = _batch()
    plan, step = train_loop.compile_train_step(cfg, tc, mesh, batch)
    state2, m = step(state, batch)
    assert state2["step"] == 1 and plan.n_groups == 2
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=F32_TOL)
    got = sharding.gather(state2)
    want = interop.state_from_jax(after, cfg, device="cpu")
    _close_leaves(got["opt"]["m"], want["opt"]["m"], F32_TOL)
    _close_leaves(got["opt"]["v"], want["opt"]["v"], F32_TOL)
    p0 = dict(_paths(p0))
    for name, p in _paths(got["params"]):
        assert not torch.equal(p, p0[name]), name          # every leaf moved
    _params_close(got["params"], want["params"], want["opt"]["m"], jm["lr"],
                  F32_TOL)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded(arch, mesh_shape):
    """f64; on four distinct CPU devices, so replicated blocks have copies.
    (1, 4): granite's kv_heads (2 in the tiny config) do not split four
    ways, so wk/wv are replicated and each shard takes its q heads' KV
    head."""
    cfg = dataclasses.replace(configs.tiny(configs.get(arch)),
                              dtype="float64", param_dtype="float64")
    mesh = _mesh("four", mesh_shape)
    ref = train_loop.init_state(cfg, device="cpu", seed=5)
    state = _placed(train_loop.init_state(cfg, device="cpu", seed=5), cfg, mesh)
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(**OPT))
    batch = _batch(seed=2)
    # K6 takes f32 and bf16: Griffin runs its plain version (autograd) in f64
    kw = {"use_kernel_conv": False} if cfg.family == "hybrid" else {}
    _, step = train_loop.compile_train_step(cfg, tc, mesh, batch, **kw)
    state, m = step(state, batch)
    ref, mr = train_loop.make_train_step(cfg, tc, **kw)(ref, batch)
    np.testing.assert_allclose(float(m["loss"]), float(mr["loss"]), rtol=1e-12)
    np.testing.assert_allclose(float(m["grad_norm"]), float(mr["grad_norm"]),
                               rtol=UNSHARDED_TOL)
    got = sharding.gather(state)
    _close_leaves(got["opt"], ref["opt"], UNSHARDED_TOL)
    _params_close(got["params"], ref["params"], ref["opt"]["m"], float(mr["lr"]),
                  UNSHARDED_TOL)
    copies = 0
    for _, leaf in _paths({"p": state["params"], "o": state["opt"]}):
        for reps in leaf.replicas():
            copies += len(reps) - 1
            assert all(torch.equal(r, reps[0]) for r in reps[1:])
    assert copies > 0


def test_sharded_step_advances_in_place_and_donate_false_copies():
    _, cfg = _cfgs("phi3-mini-3.8b")
    mesh = _mesh()
    state = _placed(train_loop.init_state(cfg, device="cpu", seed=1), cfg, mesh)
    before = sharding.gather(state["params"])
    batch = _batch()
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(**OPT))
    _, keep = train_loop.compile_train_step(cfg, tc, mesh, batch, donate=False)
    new, _ = keep(state, batch)
    for (_, a), (_, b) in zip(_paths(sharding.gather(state["params"])),
                              _paths(before)):
        assert torch.equal(a, b)
    _, step = train_loop.compile_train_step(cfg, tc, mesh, batch)
    new2, _ = step(state, batch)
    assert new2["params"] is state["params"]
    for (_, a), (_, b) in zip(_paths(sharding.gather(new2["params"])),
                              _paths(sharding.gather(new["params"]))):
        assert torch.equal(a, b)


def test_plan_counts_bytes():
    _, cfg = _cfgs("recurrentgemma-9b")
    mesh = _mesh()
    batch = _batch()
    plan, _ = train_loop.compile_train_step(cfg, train_loop.TrainConfig(), mesh,
                                            batch)
    specs = train_loop.state_specs(cfg)
    whole = sum(t.numel() * t.element_size()
                for part in ("params", "opt") for _, t in _paths(specs[part]))
    # one shard holds at least a quarter of the state, the one device all
    # of it once
    assert whole / 4 <= plan.state_bytes_per_shard <= whole
    assert plan.state_bytes_per_device == {torch.device("cpu"): whole}
    assert plan.batch_bytes_per_shard == 2 * (4 // 2) * 16 * 4
    st, bs = plan.in_shardings
    assert bs["tokens"].spec == ("data",)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "pixtral-12b", "xlstm-1.3b",
                                  "whisper-small"])
def test_other_families_under_a_mesh_are_not_ported(arch):
    cfg = configs.tiny(configs.get(arch))
    with pytest.raises(NotImplementedError, match="item 9b"):
        train_loop.compile_train_step(cfg, train_loop.TrainConfig(), _mesh(),
                                      _batch())
    # their shardings and placement work
    sh = train_loop.state_shardings(cfg, _mesh())
    st = train_loop.init_state(cfg, device="cpu")
    back = sharding.gather(sharding.device_put(st, sh))
    for (_, a), (_, b) in zip(_paths(back["params"]), _paths(st["params"])):
        assert torch.equal(a, b)


def test_model_split_reductions_raise():
    """An operation that would reduce along the model-split dimension of a
    value raises instead of computing a shard's part alone."""
    mesh = _mesh(shape=(1, 2))
    g = sharded.groups(mesh)[0]
    x = g.split(g.replicate(torch.randn(2, 3, 8)), 2)
    with pytest.raises(ValueError, match="model-split"):
        x.mean(dim=-1)
    with pytest.raises(ValueError, match="model-split"):
        torch.softmax(x, dim=2)
    with pytest.raises(ValueError, match="model-split"):
        x.reshape(6, 8)
    y = torch.softmax(x, dim=1)                       # along another dim: fine
    assert y.sdim == 2
    assert torch.allclose(g.relayout(y, None).parts[0],
                          torch.softmax(g.relayout(x, None).parts[0], dim=1))


def test_sharded_logsumexp_and_gather():
    mesh = _mesh(shape=(1, 4))
    g = sharded.groups(mesh)[0]
    lg = torch.randn(2, 5, 16)
    idx = torch.randint(0, 16, (2, 5, 1))
    x = g.split(g.replicate(lg), 2)
    lse = torch.logsumexp(x, dim=-1)
    assert lse.sdim is None
    torch.testing.assert_close(lse.parts[0], torch.logsumexp(lg, -1))
    assert torch.equal(torch.gather(x, -1, idx).parts[0], torch.gather(lg, -1, idx))


# -- elastic restore -------------------------------------------------------------
def test_elastic_reshard_restore(tmp_path):
    """A checkpoint written unsharded restores onto a (2, 2) mesh, and one
    written from the mesh restores unsharded (leaves saved whole)."""
    _, cfg = _cfgs("granite-8b")
    d = str(tmp_path / "ck")
    state = train_loop.init_state(cfg, device="cpu", seed=2)
    checkpoint.save(d, 1, state)
    mesh = _mesh()
    shard = train_loop.state_shardings(cfg, mesh)
    st = checkpoint.restore(d, train_loop.state_specs(cfg), shardings=shard)
    leaf = st["params"]["final_norm"]["scale"]
    assert isinstance(leaf, sharding.ShardedTensor) and leaf.mesh is mesh
    assert st["step"] == 0
    for (_, a), (_, b) in zip(_paths(sharding.gather(st)), _paths(state)):
        assert (a == b) if not torch.is_tensor(a) else torch.equal(a, b)
    total = sum(int(np.prod(t.shape)) for _, t in _paths(st)
                if hasattr(t, "shape"))
    assert total == sum(t.numel() for _, t in _paths(state) if torch.is_tensor(t))
    d2 = str(tmp_path / "ck2")
    checkpoint.save(d2, 2, st)
    back = checkpoint.restore(d2, train_loop.init_state(cfg, device="cpu", seed=9))
    for (_, a), (_, b) in zip(_paths(back), _paths(state)):
        assert (a == b) if not torch.is_tensor(a) else torch.equal(a, b)
    # onto another layout: the production mesh of CPU shards
    big = M.make_production_mesh(devices=["cpu"])
    st3 = checkpoint.restore(d2, train_loop.state_specs(cfg),
                             shardings=train_loop.state_shardings(cfg, big))
    for (_, a), (_, b) in zip(_paths(sharding.gather(st3)), _paths(state)):
        assert (a == b) if not torch.is_tensor(a) else torch.equal(a, b)


def test_sharded_restart_is_bit_for_bit(tmp_path):
    """``run_with_restarts(shardings=)``: a failure before step 3 of 4, the
    restart restores onto the mesh and ends where the uninterrupted
    sharded run ends."""
    _, cfg = _cfgs("phi3-mini-3.8b")
    mesh = _mesh()
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(**OPT))
    batches = [_batch(seed=s) for s in range(4)]
    _, step = train_loop.compile_train_step(cfg, tc, mesh, batches[0])
    shard = train_loop.state_shardings(cfg, mesh)

    def init_fn():
        return train_loop.init_sharded_state(cfg, mesh, seed=3)

    def one(state, s):
        return step(state, batches[s])[0]

    ref = init_fn()
    for s in range(4):
        ref = one(ref, s)
    inj = fault_tolerance.FailureInjector([2])
    got = fault_tolerance.run_with_restarts(
        init_fn=init_fn, step_fn=one, n_steps=4, ckpt_dir=str(tmp_path / "ck"),
        ckpt_every=1, shardings=shard, injector=inj)
    assert inj.fired == [2] and got["step"] == 4
    for (_, a), (_, b) in zip(_paths(sharding.gather(got)),
                              _paths(sharding.gather(ref))):
        assert (a == b) if not torch.is_tensor(a) else torch.equal(a, b)
