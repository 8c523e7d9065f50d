"""Port parity: the sharding rules (``repro_torch.sharding``) against the
JAX package's ``sharding.py``, and the port's placement of a tree on a
mesh.

The JAX package's ``NamedSharding`` wants a real ``jax.sharding.Mesh`` of
as many devices; its ``resolve`` reads nothing of a mesh but ``shape``, so
the JAX side runs on a stand-in mesh whose ``shape`` is a dict (and its
``NamedSharding`` is patched to a record of the spec while a test builds
cache and batch shardings).  The port's leaves are one dict a layer; each
is held to its JAX counterpart's spec without the lead entry of a stacked
leaf.  Specs are compared entry for entry (tuples of mesh-axis names).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import sharding as jsh  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs, interop, sharding  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(jconfigs.base.names()) if hasattr(jconfigs, "base") \
    else sorted(jconfigs.names())


class _Mesh:
    """What the JAX package's ``resolve`` reads of a mesh."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


class _Spec:
    """A JAX spec, a leaf of the trees the patched ``NamedSharding`` gives."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


def _port_mesh(key):
    shape, names = MESHES[key]
    return M.make_mesh(shape, names, devices=["cpu"])


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, pre + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, pre + (i,))
    else:
        yield pre, tree


@functools.lru_cache(maxsize=None)
def _jax_param_specs(arch, key):
    cfg = jconfigs.get(arch)
    mesh = _Mesh(*MESHES[key])
    flat, _ = jax.tree_util.tree_flatten_with_path(japi.param_shapes(cfg))
    out = {}
    for path, leaf in flat:
        ps = jsh._path_str(path)
        out[ps] = tuple(jsh.resolve(jsh.logical_axes_for(ps, leaf.shape, cfg),
                                    leaf.shape, mesh))
    return out


def _strip(spec, stacked):
    """A stacked JAX leaf's spec without its lead (layer) entry."""
    spec = tuple(spec)
    return spec[1:] if stacked else spec


def test_configs_match():
    assert sorted(configs.names()) == ARCHS and len(ARCHS) == 10
    for a in ARCHS:
        assert dataclasses.asdict(configs.get(a)) == \
            dataclasses.asdict(jconfigs.get(a))


@pytest.mark.parametrize("key", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, key):
    cfg = configs.get(arch)
    want = _jax_param_specs(arch, key)
    got = sharding.param_shardings(cfg, _port_mesh(key),
                                   api.init_params(cfg, device="meta"))
    seen = set()
    for path, s in _paths(got):
        jpath, stacked = sharding.jax_leaf_path(cfg, path)
        assert jpath in want, (path, jpath)
        assert tuple(s.spec) == _strip(want[jpath], stacked), (path, jpath)
        seen.add(jpath)
    assert seen == set(want)            # every JAX leaf has a counterpart


def test_odd_rules_ported_as_they_are():
    """Griffin's wi [w, w] (under ``cycles``/``tail``) takes the mLSTM
    scalar-gate rule before the dense-MLP one, ("embed", "heads"), which
    binds as ("embed", "ff") would; tok's second data use is dropped;
    kv_heads=1 stays replicated; granite (kv 8) on model 16 gives 'seq',
    gemma (kv 16) 'heads'."""
    rg = configs.get("recurrentgemma-9b")
    mesh = _Mesh((16, 16), ("data", "model"))
    axes = sharding.port_leaf_axes(rg, ("blocks", 0, "mix", "wi"), (4096, 4096))
    assert axes == ("embed", "heads")
    assert tuple(sharding.resolve(axes, (4096, 4096), mesh)) == \
        tuple(sharding.resolve(("embed", "ff"), (4096, 4096), mesh)) == \
        ("data", "model")
    assert sharding.port_leaf_axes(rg, ("embed", "tok"), (256000, 4096)) \
        == ("vocab_table", "embed")
    assert tuple(sharding.resolve(("vocab_table", "embed"), (256000, 4096),
                                  mesh)) == ("data",)
    wk = sharding.port_leaf_axes(rg, ("blocks", 2, "mix", "attn", "wk"),
                                 (4096, 1, 256))
    assert tuple(sharding.resolve(wk, (4096, 1, 256), mesh)) == ("data",)
    for arch, mode in (("granite-8b", "seq"), ("gemma-7b", "heads")):
        with sharding.use_activation_mesh(mesh):
            assert sharding.kv_cache_mode(configs.get(arch)) == mode


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_mode_matches_jax(arch):
    mesh = _Mesh((16, 16), ("data", "model"))
    with sharding.use_activation_mesh(mesh):
        got = sharding.kv_cache_mode(configs.get(arch))
    with jsh.use_activation_mesh(mesh):
        want = jsh.kv_cache_mode(jconfigs.get(arch))
    assert got == want
    assert sharding.kv_cache_mode(configs.get(arch)) is None  # no mesh


def _cache_jax_path(cfg, path):
    """The JAX cache leaf of the port's cache leaf at ``path`` (and whether
    it is stacked there)."""
    if path == ("pos",):
        return "pos", False
    if path[0] == "blocks":
        return sharding.jax_leaf_path(cfg, path)
    name = path[-1]                                  # layers/<i>/k|v|xk|xv
    return (f"kv/{name}" if name in ("k", "v") else name), True


@pytest.mark.parametrize("key", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch, key, monkeypatch):
    monkeypatch.setattr(jsh, "NamedSharding", _Spec)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    jmesh = _Mesh(*MESHES[key])
    mesh = _port_mesh(key)
    for sname, shape in shapes.SHAPES.items():
        if not shapes.applicable(cfg, shape)[0]:
            continue
        got = shapes.input_specs(cfg, shape)
        want = jshapes.input_specs(jcfg, jshapes.SHAPES[sname])
        batch = {k: v for k, v in got.items() if k != "cache"}
        wbatch = {k: v for k, v in want.items() if k != "cache"}
        assert {k: tuple(v.shape) for k, v in batch.items()} == \
            {k: tuple(v.shape) for k, v in wbatch.items()}
        gb = sharding.batch_shardings(cfg, mesh, batch)
        wb = jsh.batch_shardings(jcfg, jmesh, wbatch)
        for k in batch:
            assert tuple(gb[k].spec) == wb[k].spec, (sname, k)
        if "cache" not in got:
            continue
        wc = jsh.cache_shardings(jcfg, jmesh, want["cache"])
        wflat = {jsh._path_str(p): s.spec for p, s in
                 jax.tree_util.tree_flatten_with_path(wc)[0]}
        gc = sharding.cache_shardings(cfg, mesh, got["cache"])
        n = 0
        for path, s in _paths(gc):
            jpath, stacked = _cache_jax_path(cfg, path)
            assert tuple(s.spec) == _strip(wflat[jpath], stacked), (sname, path)
            n += 1
        assert n == len(list(_paths(got["cache"])))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "granite-8b",
                                  "mixtral-8x7b", "xlstm-1.3b", "whisper-small",
                                  "pixtral-12b"])
@pytest.mark.parametrize("devices", ["one", "four"])
def test_device_put_then_gather_is_the_identity(arch, devices):
    """Every family's train state split over a (2, 2) CPU mesh and joined
    back bit for bit; shards hold their blocks; replicas on one device are
    one tensor, on four (``cpu:0`` .. ``cpu:3``) four equal ones."""
    cfg = configs.tiny(configs.get(arch))
    devs = ["cpu"] if devices == "one" else [torch.device("cpu", i) for i in range(4)]
    mesh = M.make_mesh((2, 2), ("data", "model"), devices=devs)
    state = train_loop.init_state(cfg, device="cpu", seed=4)
    placed = sharding.device_put(state, train_loop.state_shardings(cfg, mesh))
    back = sharding.gather(placed)
    assert back["step"] == state["step"] == 0
    for (p, a), (_, b), (_, s) in zip(_paths(state["params"]),
                                      _paths(back["params"]),
                                      _paths(placed["params"])):
        assert torch.equal(a, b), p
        assert isinstance(s, sharding.ShardedTensor) and s.shape == a.shape
        for pos in s.positions():
            blk = s.sharding.block_of(a.shape, pos)
            assert torch.equal(s.shard(pos), a[tuple(slice(*x) for x in blk)])
        n_dev = len(set(map(str, mesh.devices.flat))) if devices == "one" else 4
        n_pos = mesh.size // len(s.blocks)
        for copies in s.replicas():
            assert len(copies) == min(n_pos, n_dev if devices == "four" else 1)
            assert all(torch.equal(c, copies[0]) for c in copies)


def test_device_put_donate_frees_the_source_leaves():
    cfg = configs.tiny(configs.get("granite-8b"))
    mesh = M.make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    params = api.init_params(cfg, device="cpu", seed=0)
    want = api.init_params(cfg, device="cpu", seed=0)
    placed = sharding.device_put(params, train_loop.state_shardings(
        cfg, mesh)["params"], donate=True)
    assert all(v is None for _, v in _paths(params))
    for (_, a), (_, b) in zip(_paths(sharding.gather(placed)), _paths(want)):
        assert torch.equal(a, b)


def test_production_mesh():
    m = M.make_production_mesh(devices=["cpu"])
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m = M.make_production_mesh(multi_pod=True, devices=["cpu"])
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert sharding.constrain(x, "batch", "seq", "embed") is x
    tree = {"a": torch.ones(4, 8)}
    assert sharding.constrain_like_params(tree, configs.tiny(
        configs.get("granite-8b"))) is tree


def test_constrain_like_params_places_a_tree():
    cfg = configs.tiny(configs.get("granite-8b"))
    mesh = M.make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    params = api.init_params(cfg, device="cpu", seed=1)
    want = sharding.param_shardings(cfg, mesh, params)
    with sharding.use_activation_mesh(mesh):
        placed = sharding.constrain_like_params(params, cfg)
        again = sharding.constrain_like_params(placed, cfg)
    for (p, s), (_, w), (_, a), (_, b) in zip(
            _paths(placed), _paths(want), _paths(again), _paths(params)):
        assert s.sharding == w and a is s, p
        assert torch.equal(s.gather(), b)


def test_state_shardings_and_specs():
    cfg = configs.tiny(configs.get("recurrentgemma-9b"))
    mesh = M.make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    sh = train_loop.state_shardings(cfg, mesh)
    specs = train_loop.state_specs(cfg)
    assert tuple(sh["step"].spec) == () and specs["step"] == 0
    for a, b, c in zip(tree_leaves(sh["params"]), tree_leaves(sh["opt"]["m"]),
                       tree_leaves(sh["opt"]["v"])):
        assert a == b == c
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in tree_leaves(specs["opt"]))


# -- the grouped decode attention -------------------------------------------------
@pytest.mark.parametrize("kv_mode", ["heads", "seq"])
def test_grouped_sdpa_matches_jax(kv_mode):
    """``_sdpa(kv_mode=...)``'s grouped forms (no mesh: the constraints are
    the identity) against the JAX package's, and against the expanded form,
    f32."""
    rng = np.random.default_rng(3)
    B, Sq, H, K, D, Sk = 2, 1, 8, 2, 16, 12
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, K, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, D)).astype(np.float32)
    mask = rng.random((B, 1, Sq, Sk)) > 0.3
    mask[..., 0] = True
    want = np.asarray(jlayers._sdpa(q, k, v, mask, 0.25, kv_mode=kv_mode))
    t = [torch.tensor(a) for a in (q, k, v, mask)]
    got = L._sdpa(*t, 0.25, kv_mode=kv_mode)
    expanded = L._sdpa(*t, 0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), expanded.numpy(), rtol=1e-5, atol=1e-6)


def test_state_from_jax_places_on_a_mesh():
    """The JAX package's train state carried across and placed (the route
    of the sharded tests), joined back equal."""
    from repro.train import train_loop as jtl
    jcfg = jconfigs.tiny(jconfigs.get("granite-8b"))
    cfg = configs.tiny(configs.get("granite-8b"))
    js = jax.tree.map(np.asarray, jtl.init_state(jcfg, jax.random.PRNGKey(0)))
    state = interop.state_from_jax(js, cfg, device="cpu")
    mesh = M.make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    placed = sharding.device_put(state, train_loop.state_shardings(cfg, mesh))
    for (_, a), (_, b) in zip(_paths(sharding.gather(placed)), _paths(state)):
        assert (a == b) if not torch.is_tensor(a) else torch.equal(a, b)
