"""The port's entry points that the examples reach, held against the JAX
package on the same numpy inputs:

- ``acoustic.run(mesh=)``: the per-step and fused paths on a (4, 2) mesh
  of CPU shards equal the unsharded port bit for bit, and the JAX
  package's single-device ``acoustic.run(backend=st.xla())`` at 32³
  within 2e-5 of the field's max (the JAX package's own distributed path
  fails under its installed JAX: ROADMAP.md, reference caveats);
- ``timeloop.run_timeloop(mesh=)``: a sharded run equals the unsharded one
  bit for bit and JAX's ``run_timeloop`` under ``st.xla()`` within 1e-5
  of each field's max;
- ``ops.stencil_timeloop(batch=, mem_type=)``: every scenario of a batched
  run against JAX's batched xla ``run_timeloop`` (1e-5 of each field's
  max; JAX's own ``stencil_timeloop`` runs its fused Pallas path, which
  fails under the installed JAX) and bit for bit against its own
  unbatched run;
- ``shapes.batch_dims`` equal to JAX's, and ``shapes.make_host_batch``'s
  ids and embeddings equal to JAX's ``make_host_batch`` bit for bit, on a
  device, with a decode cell's cache ``api.init_cache``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import dsl as jst  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro.core import timeloop as jtl  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.core import acoustic, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.core import timeloop as tl  # noqa: E402
from repro_torch.kernels.stencil import ops  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import api  # noqa: E402

CPU = [torch.device("cpu")]


def _interior(a, order=4):
    return np.asarray(a)[(slice(order, -order),) * 3]


# ---- acoustic.run(mesh=) -----------------------------------------------------------
@pytest.mark.parametrize("fuse", [None, 4], ids=["per_step", "fused"])
@pytest.mark.parametrize("inner", ["torch", "gmem"])
def test_acoustic_run_on_a_mesh(fuse, inner):
    shape, iters = (32, 32, 32), 12
    be = st.torch() if inner == "torch" else st.hopper(template=inner)
    mesh = pmesh.make_mesh((4, 2), ("data", "model"), devices=CPU)
    dist = st.distributed(grid_axes=("data", "model", None), overlap=True,
                          inner=be)
    got, prof = acoustic.run(shape=shape, iters=iters, backend=dist,
                             mesh=mesh, pml_width=6, fuse_steps=fuse,
                             device="cpu")
    one, _ = acoustic.run(shape=shape, iters=iters, backend=be, pml_width=6,
                          fuse_steps=fuse, device="cpu")
    assert torch.equal(got.interior, one.interior)
    want, _ = jacoustic.run(shape=shape, iters=iters, backend=jst.xla(),
                            pml_width=6, fuse_steps=fuse)
    want = np.asarray(want.interior)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got.interior.numpy() - want).max()) <= 2e-5 * scale
    if fuse:
        assert {"scatter", "gather"} <= set(prof)


# ---- timeloop.run_timeloop(mesh=) ----------------------------------------------------
def test_run_timeloop_on_a_mesh():
    k, jk = suite.get_kernel("star3d2r"), jsuite.get_kernel("star3d2r")
    shape, h = (16, 16, 24), k.info.order
    rng = np.random.default_rng(3)
    init = {g: np.pad(rng.standard_normal(shape).astype(np.float32),
                      h) for g in k.ir.grid_params}
    halos = {g: (h,) * 3 for g in k.ir.grid_params}
    kw = dict(halos=halos, interior_shape=shape, swap=("v", "u"),
              fuse_steps=3)
    mesh = pmesh.make_mesh((2, 2), ("data", "model"), devices=CPU)
    be = st.distributed(grid_axes=("data", "model", None))
    got = tl.run_timeloop(k.ir, {g: torch.from_numpy(a.copy()) for g, a in init.items()},
                          {}, 7, backend=be, mesh=mesh, **kw)
    one = tl.run_timeloop(k.ir, {g: torch.from_numpy(a.copy()) for g, a in init.items()},
                          {}, 7, backend=st.torch(), **kw)
    want = jtl.run_timeloop(jk.ir, {g: jnp.asarray(a) for g, a in init.items()},
                            {}, 7, backend=jst.xla(), **kw)
    for g in k.ir.grid_params:
        a, b = _interior(got[g].numpy(), h), _interior(one[g].numpy(), h)
        np.testing.assert_array_equal(a, b)
        w = _interior(want[g], h)
        assert np.abs(a - w).max() <= 1e-5 * np.abs(w).max(), g


# ---- ops.stencil_timeloop(batch=, mem_type=) -------------------------------------------
@pytest.mark.parametrize("template,time_block", [("gmem", 1), ("shift", 1),
                                                 ("shift", 2)])
def test_stencil_timeloop_batched(template, time_block):
    k, jk = suite.get_kernel("star3d1r"), jsuite.get_kernel("star3d1r")
    shape, h, B, steps = (12, 14, 16), 1, 3, 6
    rng = np.random.default_rng(7)
    init = {g: np.pad(rng.standard_normal((B,) + shape).astype(np.float32),
                      ((0, 0),) + ((h, h),) * 3) for g in k.ir.grid_params}
    halos = {g: (h,) * 3 for g in k.ir.grid_params}
    got = ops.stencil_timeloop(
        k, {g: torch.from_numpy(a.copy()) for g, a in init.items()}, steps,
        swap=("v", "u"), template=template, mem_type="registers",
        time_block=time_block, fuse_steps=3, batch=B)
    want = jtl.run_timeloop(jk.ir, {g: jnp.asarray(a) for g, a in init.items()},
                            {}, steps, halos=halos, interior_shape=shape,
                            backend=jst.xla(), swap=("v", "u"), fuse_steps=3,
                            batch=B)
    for g in k.ir.grid_params:
        a, w = got[g].numpy()[:, 1:-1, 1:-1, 1:-1], np.asarray(want[g])[:, 1:-1, 1:-1, 1:-1]
        assert np.abs(a - w).max() <= 1e-5 * np.abs(w).max(), g
    for b in range(B):
        one = ops.stencil_timeloop(
            k, {g: torch.from_numpy(a[b].copy()) for g, a in init.items()},
            steps, swap=("v", "u"), template=template, time_block=time_block,
            fuse_steps=3)
        for g in k.ir.grid_params:
            assert torch.equal(got[g][b], one[g]), (b, g)


def test_stencil_timeloop_refuses_an_unknown_mem_type():
    k = suite.get_kernel("star3d1r")
    arrays = {g: torch.zeros(6, 6, 6) for g in k.ir.grid_params}
    with pytest.raises(ValueError, match="mem_type"):
        ops.stencil_timeloop(k, arrays, 1, swap=("v", "u"), mem_type="smem")


# ---- shapes.batch_dims, shapes.make_host_batch ---------------------------------------
CELLS = [("granite-8b", "train_4k"), ("pixtral-12b", "prefill_32k"),
         ("whisper-small", "train_4k"), ("recurrentgemma-9b", "decode_32k"),
         ("xlstm-1.3b", "decode_32k")]


def _small(shape):
    return dataclasses.replace(shape, seq_len=64, global_batch=2)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_dims_match_jax(arch, shape):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert shapes.batch_dims(cfg, shapes.SHAPES[shape]) == \
        jshapes.batch_dims(jcfg, jshapes.SHAPES[shape])
    assert set(shapes.__all__) == set(jshapes.__all__)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_make_host_batch_matches_jax(arch, shape):
    cfg = configs.tiny(configs.get(arch))
    jcfg = jconfigs.tiny(jconfigs.get(arch))
    spec = _small(shapes.SHAPES[shape])
    got = shapes.make_host_batch(cfg, spec, seed=5, device="cpu")
    want = jshapes.make_host_batch(jcfg, _small(jshapes.SHAPES[shape]), seed=5)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name == "cache":
            cache = api.init_cache(cfg, spec.global_batch,
                                   api.decode_cache_len(cfg, spec.seq_len),
                                   device="cpu")
            assert [(x.shape, x.dtype) for x in _tensor_leaves(got[name])] == \
                [(x.shape, x.dtype) for x in _tensor_leaves(cache)]
            continue
        g = got[name]
        assert g.device.type == "cpu" and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
        assert g.numpy().dtype == w.dtype


def _tensor_leaves(tree):
    """The tensors of a port cache tree, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def test_make_host_batch_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shapes.make_host_batch(configs.tiny(configs.get("granite-8b")),
                               _small(shapes.SHAPES["train_4k"]))
