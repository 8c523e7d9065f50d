"""Port parity: the sharded prefill and decode steps
(``launch.dryrun.compile_prefill_step``, ``serve_loop.compile_serve_step``)
one tiny config a family, on (2, 2) and (1, 4) meshes of four distinct CPU
devices: against the JAX package's single-device prefill (its
``launch/dryrun.make_prefill_step``: ``forward_hidden``, then ``unembed``
of the last position) and ``serving/serve_loop.make_serve_step`` in f32,
on the same parameters (``interop.params_from_jax``), cache and tokens;
and against the port's unsharded steps in f64.

The tiny configs have 2 KV heads: on (2, 2) the cache splits by heads
(``kv_mode="heads"``), on (1, 4) by sequence (``kv_mode="seq"``: each
shard's logsumexp combined across the shards, a new position written into
the one shard that holds its slot).  Tolerances: against JAX, the f32
logits within ``F32_TOL`` = 1e-5 of the largest |logit|; against the
port's unsharded steps, the f64 logits within ``TOL`` = 1e-9 of it (the
sums run in another order); greedy tokens token for token in both.
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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving import serve_loop as jserve  # noqa: E402
from repro_torch import configs, interop, sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import api, encdec, sharded  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402

TOL = 1e-9
F32_TOL = 1e-5
FAMILIES = ("granite-8b", "mixtral-8x7b", "pixtral-12b", "xlstm-1.3b",
            "whisper-small", "recurrentgemma-9b")
B, S, NEW, CACHE = 4, 6, 5, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return M.make_mesh(shape, ("data", "model"),
                       devices=[torch.device("cpu", i) for i in range(4)])


def _cfg(arch):
    return dataclasses.replace(configs.tiny(configs.get(arch)),
                               dtype="float64", param_dtype="float64")


def _jax_cfgs(arch, **over):
    """(JAX config, port config): tiny ``arch`` in f32 (and ``over``),
    equal fields."""
    j = dataclasses.replace(jconfigs.tiny(jconfigs.get(arch)), dtype="float32", **over)
    t = dataclasses.replace(configs.tiny(configs.get(arch)), dtype="float32", **over)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _kw(cfg):
    # K6 takes f32 and bf16: Griffin runs its plain version in f64
    return {"use_kernel_conv": False} if cfg.family == "hybrid" else {}


def _inputs(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    dt = np.float64 if cfg.dtype == "float64" else np.float32
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((b, cfg.n_prefix_tokens,
                                                     cfg.d_model)).astype(dt)
    if cfg.family == "audio":
        batch["frame_embeds"] = rng.standard_normal((b, 12, cfg.d_model)).astype(dt)
    return batch


def _cache(cfg, params, batch):
    if cfg.family == "audio":
        enc = encdec.encode(params, torch.as_tensor(batch["frame_embeds"]), cfg)
        return encdec.build_cache(params, enc, cfg, B, CACHE)
    return api.init_cache(cfg, B, api.decode_cache_len(cfg, CACHE), device="cpu")


def _placed(cfg, params, mesh):
    return sharding.device_put(params, sharding.param_shardings(
        cfg, mesh, api.init_params(cfg, device="meta")))


def _decode(cfg, params, cache, toks, step, generator=None):
    """Feed the prompt, then ``NEW`` tokens of ``step``'s choosing: (the
    last position's logits a step, the new tokens, the last cache)."""
    cur, logits, out = torch.as_tensor(toks[:, :1]), [], []
    for t in range(S + NEW - 1):
        lg, cache = step(params, cache, cur)
        logits.append(lg)
        if t + 1 < S:
            cur = torch.as_tensor(toks[:, t + 1:t + 2])
        else:
            cur = serve_loop._next(lg, True, 0.7, generator).cpu()
            out.append(cur)
    return logits, torch.cat(out, dim=1), cache


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_prefill_and_decode_match_unsharded(arch, mesh_shape):
    cfg = _cfg(arch)
    mesh = _mesh(mesh_shape)
    batch = _inputs(cfg)
    params = api.init_params(cfg, device="cpu", seed=3)
    ps = _placed(cfg, params, mesh)

    want = dryrun.make_prefill_step(cfg, **_kw(cfg))(
        params, {k: torch.as_tensor(v) for k, v in batch.items()})
    plan, prefill = dryrun.compile_prefill_step(cfg, mesh, batch, **_kw(cfg))
    got = prefill(ps, batch)
    assert isinstance(got, sharding.ShardedTensor)
    assert got.sharding == plan.out_sharding and tuple(got.shape) == (B, 1, cfg.vocab)
    assert float((got.gather() - want).abs().max()) <= TOL * float(want.abs().max())

    cache = _cache(cfg, params, batch)
    splan, sstep = serve_loop.compile_serve_step(cfg, mesh, cache, sample=False,
                                                 **_kw(cfg))
    assert splan.kv_mode == ("heads" if mesh_shape == (2, 2) and cfg.n_kv_heads == 2
                             else "seq")
    placed = sharding.device_put(_cache(cfg, params, batch), splan.cache_shardings)

    def ustep(p, c, t):
        lg, c = api.decode_step(cfg, p, c, t, **_kw(cfg))
        return L.wide(lg[:, -1]), c
    want_l, want_t, cache = _decode(cfg, params, cache, batch["tokens"], ustep)
    got_l, got_t, new = _decode(cfg, ps, placed, batch["tokens"], sstep)
    assert torch.equal(got_t, want_t)
    for a, b in zip(got_l, want_l):
        assert float((a - b).abs().max()) <= TOL * float(b.abs().max())
    # the cache was written in place on its shards (the step's cache holds
    # the same leaves): its gather is the unsharded step's cache
    assert all(a is b for (_, a), (_, b) in zip(_leaves(new), _leaves(placed))
               if isinstance(a, sharding.ShardedTensor))
    assert new["pos"] == cache["pos"] == S + NEW - 1
    for (_, a), (_, b) in zip(_leaves(placed), _leaves(cache)):
        if isinstance(a, sharding.ShardedTensor):
            assert float((a.gather() - b).abs().max()) <= TOL * max(
                float(b.abs().max()), 1.0)


@functools.lru_cache(maxsize=None)
def _jax_reference(arch, b=B, n_kv_heads=None):
    """The JAX package's single-device prefill and greedy decode of tiny
    ``arch`` in f32, ``b`` rows (``n_kv_heads``: the config's, or that
    many): (port config, port params, batch, prefill logits ``[b, 1, V]``,
    the JAX initial cache in the port's layout, the logits ``[b, V]`` of
    every decode step, the greedy tokens ``[b, NEW]``, the last cache in
    the port's layout).  The prompt goes in a token a step, as ``_decode``
    feeds it."""
    jcfg, cfg = _jax_cfgs(arch, **({} if n_kv_heads is None
                                   else {"n_kv_heads": n_kv_heads}))
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    batch = _inputs(cfg, b=b)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    hid, _ = japi.forward_hidden(jcfg, jparams, jb)
    prefill = np.asarray(jlayers.unembed(jparams["embed"], hid[:, -1:], jcfg))
    if cfg.family == "audio":
        enc = jencdec.encode(jparams, jb["frame_embeds"], jcfg)
        jcache = jencdec.build_cache(jparams, enc, jcfg, b, CACHE)
    else:
        jcache = japi.init_cache(jcfg, b, japi.decode_cache_len(jcfg, CACHE))
    cache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), cfg,
                                   device="cpu")
    step = jax.jit(jserve.make_serve_step(jcfg, sample=False))
    key = jax.random.PRNGKey(0)
    cur, logits, out = batch["tokens"][:, :1], [], []
    for t in range(S + NEW - 1):
        lg, jcache = step(jparams, jcache, jnp.asarray(cur), key)
        logits.append(np.asarray(lg))
        if t + 1 < S:
            cur = batch["tokens"][:, t + 1:t + 2]
        else:
            cur = np.asarray(jnp.argmax(lg, axis=-1))[:, None].astype(np.int32)
            out.append(cur)
    last = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), cfg, device="cpu")
    return (cfg, params, batch, prefill, cache, logits, np.concatenate(out, axis=1),
            last)


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().double().numpy() - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_prefill_and_decode_match_jax(arch, mesh_shape):
    """The sharded steps in f32 on the JAX package's parameters, cache and
    tokens: prefill logits, every decode step's logits and the greedy
    tokens, against JAX's single-device prefill and ``make_serve_step``."""
    cfg, params, batch, want_p, cache, want_l, want_t, _ = _jax_reference(arch)
    mesh = _mesh(mesh_shape)
    ps = _placed(cfg, params, mesh)
    _, prefill = dryrun.compile_prefill_step(cfg, mesh, batch)
    _close(prefill(ps, batch).gather(), want_p, F32_TOL)
    plan, step = serve_loop.compile_serve_step(cfg, mesh, cache, sample=False)
    assert plan.kv_mode == ("heads" if mesh_shape == (2, 2) and cfg.n_kv_heads == 2
                            else "seq")
    placed = sharding.device_put(cache, plan.cache_shardings)
    got_l, got_t, _ = _decode(cfg, ps, placed, batch["tokens"], step)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        _close(a, b, F32_TOL)


def _odd_batches():
    for arch in FAMILIES:
        for b in (1, 3):
            yield arch, b, "heads"
            if arch != "xlstm-1.3b":        # no KV cache to split
                yield arch, b, "seq"


@pytest.mark.parametrize("arch,b,kv_mode", list(_odd_batches()),
                         ids=lambda v: str(v))
def test_sharded_decode_of_a_batch_that_does_not_split(arch, b, kv_mode):
    """A batch of ``b`` rows that does not split over (2, 2)'s two data
    groups: the cache's rows are replicated over them, the first group
    decodes every row and the other group's devices take its new cache
    rows.  The config with 2 KV heads on both sides splits the cache by
    heads, with 1 by sequence.  In f32 on
    the JAX package's parameters, cache and tokens: every decode step's
    logits and the greedy tokens against JAX's single-device
    ``make_serve_step``, and every replica of every cache block, on each
    device that holds one, against JAX's last cache, at ``F32_TOL``."""
    cfg, params, batch, _, cache, want_l, want_t, want_c = _jax_reference(
        arch, b, {"heads": 2, "seq": 1}[kv_mode])
    mesh = _mesh((2, 2))
    plan, step = serve_loop.compile_serve_step(cfg, mesh, cache, sample=False)
    assert plan.n_groups == 2 and b % plan.n_groups
    assert plan.kv_mode == kv_mode
    placed = sharding.device_put(cache, plan.cache_shardings)
    got_l, got_t, new = _decode(cfg, _placed(cfg, params, mesh), placed,
                                batch["tokens"], step)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    assert len(got_l) == len(want_l) == S + NEW - 1
    for a, w in zip(got_l, want_l):
        _close(a, w, F32_TOL)
    assert new["pos"] == want_c["pos"] == S + NEW - 1
    n = 0
    for (path, a), (_, w) in zip(_leaves(placed), _leaves(want_c)):
        if not isinstance(a, sharding.ShardedTensor):
            continue
        w = w.double().numpy()
        for block, copies in a.blocks.items():
            assert len(copies) >= 2, (path, block)     # one a data group at least
            sl = tuple(slice(lo, hi) for lo, hi in block)
            for dev, t in copies.items():
                err = float(np.abs(t.double().numpy() - w[sl]).max())
                assert err <= F32_TOL * max(float(np.abs(w).max()), 1.0), \
                    (path, block, dev, err)
                n += 1
    assert n > 0


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{pre}/{i}")
    else:
        yield pre, tree


def test_sharded_serve_step_samples_the_unsharded_tokens():
    """Temperature sampling: the sharded step gathers the rows' logits in
    global order and draws once a row from the generator, as the
    unsharded step does: the same tokens from the same seed."""
    cfg = _cfg("granite-8b")
    mesh = _mesh((2, 2))
    params = api.init_params(cfg, device="cpu", seed=4)
    batch = _inputs(cfg, seed=1)
    cache = _cache(cfg, params, batch)
    _, sstep = serve_loop.compile_serve_step(cfg, mesh, cache, sample=False)
    placed = sharding.device_put(_cache(cfg, params, batch),
                                 sharding.cache_shardings(cfg, mesh, cache))
    ustep = serve_loop.make_serve_step(cfg, sample=False)
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    _, want, _ = _decode(cfg, params, cache, batch["tokens"], ustep, g1)
    _, got, _ = _decode(cfg, _placed(cfg, params, mesh), placed, batch["tokens"],
                     sstep, g2)
    assert torch.equal(got, want)
    # and the step's own sampling draws them so too
    _, samp = serve_loop.compile_serve_step(cfg, mesh, cache, temperature=0.7)
    c = sharding.device_put(_cache(cfg, params, batch),
                            sharding.cache_shardings(cfg, mesh, cache))
    nxt, _ = samp(_placed(cfg, params, mesh), c, batch["tokens"][:, :1],
                  torch.Generator().manual_seed(5))
    ref, _ = serve_loop.make_serve_step(cfg, temperature=0.7)(
        params, _cache(cfg, params, batch), torch.as_tensor(batch["tokens"][:, :1]),
        torch.Generator().manual_seed(5))
    assert nxt.dtype == torch.int32 and torch.equal(nxt, ref)


def test_partial_softmax_over_a_seq_split_cache():
    """``_sdpa`` with ``kv_mode="seq"`` inside a group of four model shards
    (each holding 5 of 20 cache positions, some all masked) against the
    plain softmax of the unsharded ``_sdpa``."""
    mesh = _mesh((1, 4))
    g = sharded.groups(mesh)[0]
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 8, generator=gen, dtype=torch.float64)
    k = torch.randn(2, 20, 2, 8, generator=gen, dtype=torch.float64)
    v = torch.randn(2, 20, 2, 8, generator=gen, dtype=torch.float64)
    mask = (torch.arange(20) < 7)[None, None, None].expand(2, 1, 1, 20)
    want = L._sdpa(q, k, v, mask, 0.3, kv_mode="heads")   # grouped, unsplit
    with sharding.use_activation_mesh(mesh), sharding.use_group(g):
        ks, vs = g.split(g.replicate(k), 1), g.split(g.replicate(v), 1)
        got = L._sdpa(q, ks, vs, mask, 0.3, kv_mode="seq")
    assert isinstance(got, sharded.Sharded) and not got.stacked
    assert float((got.parts[0] - want).abs().max()) <= 1e-14
    ref = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(
        (0.3 * torch.einsum("bqkgd,bskd->bkgqs", q.reshape(2, 1, 2, 2, 8), k)
         ).masked_fill(~mask[:, :, None], -1e30), dim=-1), v).reshape(2, 1, 4, 8)
    assert float((want - ref).abs().max()) <= 1e-14


def test_write_into_a_seq_split_value_lands_in_the_owning_shards():
    """``__setitem__`` on a value split along dim 1 over four shards of 5:
    positions 4..6 go to shards 0 and 1 only; a write that keeps the split
    dimension whole writes each shard's block; a replicated value each
    device's copy."""
    mesh = _mesh((1, 4))
    g = sharded.groups(mesh)[0]
    base = torch.zeros(2, 20, 3)
    x = g.split(g.replicate(base.clone()), 1)
    before = [p.clone() for p in x.parts]
    val = torch.arange(18.0).reshape(2, 3, 3)
    x[:, 4:7] = val
    base[:, 4:7] = val
    assert torch.equal(g.relayout(x, None).parts[0], base)
    assert torch.equal(x.parts[2], before[2]) and torch.equal(x.parts[3], before[3])
    y = g.split(g.replicate(torch.zeros(2, 20, 4)), 2)
    y[:, 3:5] = g.split(g.replicate(torch.ones(2, 2, 4)), 2)
    assert float(g.relayout(y, None).parts[0].sum()) == 16.0
    z = g.replicate(torch.zeros(3))
    z[1:] = torch.ones(2)
    assert all(torch.equal(p, torch.tensor([0.0, 1.0, 1.0])) for p in z.parts)


def test_reshape_of_a_split_value():
    """A reshape that splits or merges the split dimension with the ones
    after it runs shard by shard; one that changes the dimensions before
    it raises."""
    mesh = _mesh((1, 2))
    g = sharded.groups(mesh)[0]
    t = torch.randn(2, 3, 8, 5)
    x = g.split(g.replicate(t), 2)
    y = x.reshape(2, 3, 4, 2, 5)
    assert y.sdim == 2
    assert torch.equal(g.relayout(y, None).parts[0], t.reshape(2, 3, 4, 2, 5))
    assert torch.equal(g.relayout(y.reshape(2, 3, 40), None).parts[0],
                       t.reshape(2, 3, 40))
    with pytest.raises(ValueError, match="model-split"):
        x.reshape(6, 8, 5)
    with pytest.raises(ValueError, match="model-split"):
        x.reshape(2, 3, 1, 40)
