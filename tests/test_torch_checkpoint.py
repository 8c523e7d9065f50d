"""Port parity: checkpoints and the restart loop (``train/checkpoint.py``,
``train/fault_tolerance.py``) against the JAX package's.

The on-disk layout is the JAX package's, with leaves numbered in
``jax.tree_util``'s order (dicts by sorted key), so a checkpoint written by
either package restores in the other (f32/f64 leaves); restored values are
compared bit for bit.  The port's own cases: ``save`` snapshots every leaf
before it returns (the port's optimizer and engine advance tensors in
place), bf16 and Python-number leaves, a template whose dicts were built
in another order, fresh tensors on the template's device and dtype.  The
restart loop: the watchdog's events, a SIGTERM answered with a final checkpoint
and a clean return, failures beyond the budget raising, and every restart
reported (``on_restart``, ``FailureInjector.fired``), each against the JAX
package's loop on the same step function.
"""
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import fault_tolerance as jft  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.train import checkpoint, fault_tolerance, train_loop  # noqa: E402


def _leaves(tree):
    return checkpoint.flatten(tree)[0]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def _tiny_state(seed=1):
    cfg = configs.tiny(configs.get("recurrentgemma-9b"))
    return train_loop.init_state(cfg, device="cpu", seed=seed)


def test_checkpoint_roundtrip_atomic(tmp_path):
    state = _tiny_state()
    d = str(tmp_path / "ck")
    checkpoint.save(d, 10, state)
    checkpoint.save(d, 20, state)
    assert checkpoint.steps(d) == [10, 20] and checkpoint.latest_step(d) == 20
    restored = checkpoint.restore(d, state, step=10)
    _assert_same(restored, state)
    assert restored["step"] == 0 and isinstance(restored["step"], int)
    checkpoint.prune(d, keep=1)
    assert checkpoint.steps(d) == [20]


def test_tmp_and_incomplete_directories_are_ignored(tmp_path):
    d = tmp_path / "ck"
    checkpoint.save(str(d), 3, {"x": torch.ones(2)})
    # a write that crashed before its rename, and a directory without a
    # manifest, are not checkpoints
    (d / "step_00000009.tmp").mkdir()
    (d / "step_00000009.tmp" / "manifest.json").write_text("{}")
    (d / "step_00000007").mkdir()
    assert checkpoint.steps(str(d)) == [3]
    assert jckpt.steps(str(d)) == [3]
    m = json.loads((d / "step_00000003" / "manifest.json").read_text())
    m["complete"] = False
    (d / "step_00000003" / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(IOError, match="incomplete"):
        checkpoint.restore(str(d), {"x": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "empty"), {"x": torch.zeros(2)})


def test_async_save_snapshots_before_returning(tmp_path):
    """The state is advanced in place right after an async save: the
    checkpoint holds the values at the save."""
    d = str(tmp_path / "ck")
    state = {"p": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "m": [torch.ones(4, dtype=torch.float64)], "step": 5}
    before = {"p": state["p"].clone(), "m": [state["m"][0].clone()], "step": 5}
    checkpoint.save(d, 5, state, blocking=False)
    state["p"].add_(100.0)
    state["m"][0].mul_(-3.0)
    checkpoint.wait()
    assert checkpoint.steps(d) == [5]
    _assert_same(checkpoint.restore(d, state), before)


def test_async_save_waits_for_the_previous_write(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3):
        checkpoint.save(d, s, {"x": torch.full((3,), float(s))}, blocking=False)
    checkpoint.wait()
    assert checkpoint.steps(d) == [1, 2, 3]
    got = checkpoint.restore(d, {"x": torch.zeros(3)}, step=2)
    assert torch.equal(got["x"], torch.full((3,), 2.0))


def test_bf16_and_number_leaves(tmp_path):
    d = str(tmp_path / "ck")
    w = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    state = {"w": w, "step": 7, "lr": 0.25, "arr": np.arange(3, dtype=np.int32),
             "flag": True}
    checkpoint.save(d, 1, state)
    m = json.loads((tmp_path / "ck" / "step_00000001" / "manifest.json").read_text())
    assert m["dtypes"][sorted(state).index("w")] == "bfloat16"
    template = {"w": torch.zeros(5, 7, dtype=torch.bfloat16), "step": 0, "lr": 0.0,
                "arr": np.zeros(3, np.int32), "flag": False}
    got = checkpoint.restore(d, template)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert got["step"] == 7 and type(got["step"]) is int
    assert got["lr"] == 0.25 and got["flag"] is True
    np.testing.assert_array_equal(got["arr"], state["arr"])


def test_restore_follows_keys_not_insertion_order(tmp_path):
    """A leapfrog carry whose dict was built in another order restores
    each grid under its own name (same shapes: a positional restore would
    swap them silently)."""
    d = str(tmp_path / "ck")
    u, v = torch.full((4, 4), 1.0), torch.full((4, 4), 2.0)
    checkpoint.save(d, 1, {"u": u, "v": v, "nest": {"b": u + 1, "a": v + 1}})
    got = checkpoint.restore(d, {"nest": {"a": torch.zeros(4, 4), "b": torch.zeros(4, 4)},
                                 "v": torch.zeros(4, 4), "u": torch.zeros(4, 4)})
    assert list(got) == ["nest", "v", "u"]
    assert torch.equal(got["u"], u) and torch.equal(got["v"], v)
    assert torch.equal(got["nest"]["a"], v + 1) and torch.equal(got["nest"]["b"], u + 1)


def test_restore_places_fresh_tensors_on_the_template(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.linspace(0, 1, 9, dtype=torch.float32)
    checkpoint.save(d, 1, {"x": x})
    tmpl = {"x": torch.zeros(9, dtype=torch.float64)}
    got = checkpoint.restore(d, tmpl)
    assert got["x"].dtype == torch.float64 and got["x"] is not tmpl["x"]
    assert torch.equal(got["x"], x.double())
    same = {"x": torch.zeros(9)}
    got = checkpoint.restore(d, same)
    assert got["x"].data_ptr() != same["x"].data_ptr()
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(d, {"x": torch.zeros(8)})
    with pytest.raises(ValueError, match="leaf count"):
        checkpoint.restore(d, {"x": torch.zeros(9), "y": torch.zeros(1)})


def _tree(rng):
    return {"b": rng.standard_normal((3, 4)).astype(np.float32),
            "a": rng.standard_normal(5).astype(np.float64),
            "n": {"y": rng.standard_normal((2, 2)).astype(np.float32),
                  "x": rng.standard_normal(3).astype(np.float32)}}


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree(np.random.default_rng(0))
    jckpt.save(d, 4, {k: (jnp.asarray(v) if not isinstance(v, dict) else
                          {kk: jnp.asarray(vv) for kk, vv in v.items()})
                      for k, v in tree.items()})
    tmpl = {"n": {"x": torch.zeros(3), "y": torch.zeros(2, 2)},
            "a": torch.zeros(5, dtype=torch.float64), "b": torch.zeros(3, 4)}
    assert checkpoint.latest_step(d) == 4
    got = checkpoint.restore(d, tmpl)
    # without x64 the JAX package holds (and writes) "a" in f32
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"].astype(np.float32))
    np.testing.assert_array_equal(got["b"].numpy(), tree["b"])
    for k in ("x", "y"):
        np.testing.assert_array_equal(got["n"][k].numpy(), tree["n"][k])


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree(np.random.default_rng(1))
    checkpoint.save(d, 2, {"n": {"y": torch.from_numpy(tree["n"]["y"]),
                                 "x": torch.from_numpy(tree["n"]["x"])},
                           "a": torch.from_numpy(tree["a"]),
                           "b": torch.from_numpy(tree["b"])})
    assert jckpt.latest_step(d) == 2
    tmpl = {"a": jnp.zeros(5, jnp.float32), "b": jnp.zeros((3, 4)),
            "n": {"x": jnp.zeros(3), "y": jnp.zeros((2, 2))}}
    got = jckpt.restore(d, tmpl)
    np.testing.assert_array_equal(np.asarray(got["b"]), tree["b"])
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"].astype(np.float32))
    np.testing.assert_array_equal(np.asarray(got["n"]["y"]), tree["n"]["y"])


# -- the restart loop -------------------------------------------------------------
def test_watchdog_flags_straggler_as_jax():
    times = [0.1] * 10 + [1.0, 0.1, 0.5, 0.12, 0.9]
    wd, jwd = fault_tolerance.Watchdog(threshold=3.0), jft.Watchdog(threshold=3.0)
    for s, t in enumerate(times):
        wd.observe(s, t)
        jwd.observe(s, t)
    assert [(e.step, e.seconds, e.median) for e in wd.events] == \
        [(e.step, e.seconds, e.median) for e in jwd.events]
    assert [e.step for e in wd.events] == [10, 12, 14]


def _counter_run(ft, ckpt, fail_at, n_steps=7, every=2, max_failures=3, tensor=True):
    """A state that adds each step's number to a counter, under the restart loop
    of ``ft`` (the port's or the JAX package's)."""
    restarts = []

    def init_fn():     # the JAX package restores array leaves only
        if tensor:
            return {"x": torch.zeros(()), "step": 0}
        return {"x": jnp.zeros(()), "step": jnp.zeros((), jnp.int32)}

    def step_fn(state, step):
        return {"x": state["x"] + (step + 1), "step": state["step"] + 1}

    kw = {"on_restart": lambda n, e: restarts.append((n, str(e)))} if ft is fault_tolerance else {}
    inj = ft.FailureInjector(fail_at)
    out = ft.run_with_restarts(init_fn=init_fn, step_fn=step_fn, n_steps=n_steps,
                               ckpt_dir=str(ckpt), ckpt_every=every,
                               max_failures=max_failures, injector=inj, **kw)
    return out, inj, restarts


def test_run_with_restarts_matches_jax_and_reports_each_restart(tmp_path):
    out, inj, restarts = _counter_run(fault_tolerance, tmp_path / "port", [1, 4])
    jout, _, _ = _counter_run(jft, tmp_path / "jax", [1, 4], tensor=False)
    assert float(out["x"]) == float(jout["x"]) == sum(range(1, 8))
    assert out["step"] == 7 and int(jout["step"]) == 7
    assert inj.fired == [1, 4] and not inj.fail_at
    assert restarts == [(1, "injected node failure at step 1"),
                        (2, "injected node failure at step 4")]
    assert checkpoint.steps(str(tmp_path / "port")) == [2, 4, 6, 7]


def test_failures_beyond_budget_raise(tmp_path):
    with pytest.raises(RuntimeError, match="injected node failure at step 1"):
        _counter_run(fault_tolerance, tmp_path / "port", [0, 1], max_failures=1)
    with pytest.raises(RuntimeError, match="injected node failure at step 1"):
        _counter_run(jft, tmp_path / "jax", [0, 1], max_failures=1, tensor=False)


def test_preemption_stops_cleanly_with_a_final_checkpoint(tmp_path):
    """A SIGTERM sent to the process itself during step 2: the loop saves
    at the end of that step and returns; the previous handler is back."""
    d = str(tmp_path / "ck")
    prev = signal.getsignal(signal.SIGTERM)

    def step_fn(state, step):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"x": state["x"] + 1}

    out = fault_tolerance.run_with_restarts(
        init_fn=lambda: {"x": torch.zeros(())}, step_fn=step_fn, n_steps=10,
        ckpt_dir=d, ckpt_every=100)
    assert float(out["x"]) == 3.0
    assert checkpoint.steps(d) == [3]
    assert signal.getsignal(signal.SIGTERM) == prev
    # a fresh run on the same directory resumes at step 3
    out = fault_tolerance.run_with_restarts(
        init_fn=lambda: {"x": torch.zeros(())}, step_fn=lambda s, i: {"x": s["x"] + 1},
        n_steps=10, ckpt_dir=d, ckpt_every=100)
    assert float(out["x"]) == 10.0 and checkpoint.steps(d) == [3, 10]
