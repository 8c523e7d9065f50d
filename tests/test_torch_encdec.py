"""Port parity: the encoder-decoder (``models/encdec.py``, whisper-small's
family) and cross-attention (``layers.attention(kv=)``) against the JAX
package's, on the JAX package's tiny whisper-small parameters carried
across by ``interop.params_from_jax`` (its decode caches by
``cache_from_jax``), with inputs made with numpy from a seed.

``encode`` (bidirectional self-attention with RoPE positions, unchunked
and blockwise over KV chunks), cross-attention alone, ``decode_train``
(cross K/V from ``_cross_kv``), ``build_cache``, and ``decode_step`` step
by step against the JAX package's from the same cache, every layer's
buffers compared after each step; one AdamW step of ``make_train_step``.

Tolerances: f32 1e-5 of the largest magnitude compared (sums in another
order); bf16 0.05 × max(1, |ref|).
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
from repro.models import layers as JL  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import api, encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

F32_TOL = 1e-5
BF16_REL = 0.05
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _model(dtype="float32", attn_chunk=None):
    kw = {"dtype": dtype, "attn_chunk": attn_chunk}
    jcfg = dataclasses.replace(jconfigs.tiny(jconfigs.get("whisper-small")), **kw)
    cfg = dataclasses.replace(configs.tiny(configs.get("whisper-small")), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device=CPU)
    return jcfg, cfg, jparams, params


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _within(got, want, tol=F32_TOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert float(np.abs(g - w).max()) <= tol * max(1.0, float(np.abs(w).max()))


def _frames(T=20, seed=0):
    return np.random.default_rng(seed).standard_normal((2, T, 64)).astype(np.float32)


@pytest.mark.parametrize("dtype,attn_chunk", [
    ("float32", None), ("float32", 8), ("bfloat16", None)],
    ids=["f32", "f32-chunked", "bf16"])
def test_encode_matches_jax(dtype, attn_chunk):
    """20 frames; chunks of 8 leave 4 padded keys in the last."""
    jcfg, cfg, jparams, params = _model(dtype, attn_chunk)
    x = _frames()
    want = jencdec.encode(jparams, jnp.asarray(x), jcfg)
    got = encdec.encode(params, torch.tensor(x), cfg)
    assert got.dtype == getattr(torch, dtype)
    _within(got, want, F32_TOL if dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("attn_chunk", [None, 8])
def test_cross_attention_matches_jax(attn_chunk):
    """Queries without RoPE against precomputed K/V at their positions,
    every key visible."""
    jcfg, cfg, jparams, params = _model("float32", attn_chunk)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    k = rng.standard_normal((2, 13, cfg.n_kv_heads, 16)).astype(np.float32)
    v = rng.standard_normal((2, 13, cfg.n_kv_heads, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 8, dtype=np.int32), (2, 5))
    kv_pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    jp = jax.tree.map(lambda a: a[1], jparams["dec_layers"]["xattn"])
    want, wc = JL.attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                            kv=(jnp.asarray(k), jnp.asarray(v)),
                            kv_positions=jnp.asarray(kv_pos))
    got, gc = L.attention(params["dec_layers"][1]["xattn"], torch.tensor(x), cfg,
                          positions=torch.tensor(pos),
                          kv=(torch.tensor(k), torch.tensor(v)),
                          kv_positions=torch.tensor(kv_pos))
    assert gc is None and wc is None
    _within(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_train_matches_jax(dtype):
    jcfg, cfg, jparams, params = _model(dtype)
    x = _frames(seed=2)
    toks = np.random.default_rng(3).integers(0, 256, (2, 11)).astype(np.int32)
    jenc = jencdec.encode(jparams, jnp.asarray(x), jcfg)
    want = jencdec.decode_train(jparams, jenc, jnp.asarray(toks), jcfg)
    enc = encdec.encode(params, torch.tensor(x), cfg)
    got = encdec.decode_train(params, enc, torch.tensor(toks), cfg)
    _within(got, want, F32_TOL if dtype == "float32" else BF16_REL)
    whid, _ = jencdec.forward(jparams, {"frame_embeds": jnp.asarray(x),
                                        "tokens": jnp.asarray(toks)}, jcfg)
    hid, aux = api.forward_hidden(cfg, params, {
        "frame_embeds": torch.tensor(x), "tokens": torch.tensor(toks)})
    assert float(aux) == 0.0
    _within(hid, whid, F32_TOL if dtype == "float32" else BF16_REL)


def _caches_equal(cache, want, tol=F32_TOL):
    assert cache["pos"] == want["pos"]
    for g, w in zip(cache["layers"], want["layers"]):
        assert g.keys() == w.keys() == {"k", "v", "xk", "xv"}
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            _within(g[k], w[k], tol)


def test_init_cache_layout():
    jcfg, cfg, _, _ = _model()
    want = interop.cache_from_jax(jax.tree.map(np.asarray, jencdec.init_cache(
        jcfg, 2, 8, enc_len=12)), cfg, device=CPU)
    _caches_equal(api.init_cache(cfg, 2, 8, device=CPU, enc_len=12), want, 0)
    full = api.init_cache(configs.get("whisper-small"), 1, 4, device="meta")
    assert len(full["layers"]) == 12
    assert tuple(full["layers"][0]["xk"].shape) == (1, 1500, 12, 64)


def test_decode_steps_match_jax():
    """From ``build_cache`` of the same encoder output, 12 steps against
    the JAX package's; the cross K/V stay as built."""
    jcfg, cfg, jparams, params = _model()
    x = _frames(T=16, seed=4)
    jenc = jencdec.encode(jparams, jnp.asarray(x), jcfg)
    jcache = jencdec.build_cache(jparams, jenc, jcfg, 2, 16)
    cache = encdec.build_cache(params, encdec.encode(params, torch.tensor(x), cfg),
                               cfg, 2, 16)
    _caches_equal(cache, interop.cache_from_jax(
        jax.tree.map(np.asarray, jcache), cfg, device=CPU))
    jstep = jax.jit(functools.partial(japi.decode_step, jcfg))
    toks = np.random.default_rng(5).integers(0, 256, (12, 2, 1))
    for s in range(12):
        wl, jcache = jstep(jparams, jcache, jnp.asarray(toks[s], jnp.int32))
        gl, cache = api.decode_step(cfg, params, cache,
                                    torch.tensor(toks[s], dtype=torch.int32))
        _within(gl, wl)
        _caches_equal(cache, interop.cache_from_jax(
            jax.tree.map(np.asarray, jcache), cfg, device=CPU))
    assert cache["pos"] == 12


def test_layout_and_decay_ranks():
    jcfg, cfg, jparams, params = _model()
    assert len(params["enc_layers"]) == len(params["dec_layers"]) == 2
    np.testing.assert_array_equal(
        params["dec_layers"][1]["xattn"]["wk"].numpy(),
        np.asarray(jparams["dec_layers"]["xattn"]["wk"][1]))
    nd = api.stacked_ndims(cfg, params)
    assert nd["enc_layers"][0]["ln1"]["bias"] == 2
    assert nd["dec_layers"][1]["xattn"]["wq"] == 4
    assert nd["enc_norm"]["scale"] == 1 and nd["embed"]["tok"] == 2


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
    toks = np.random.default_rng(6).integers(0, 256, (2, 13)).astype(np.int32)
    _train_step_matches_jax(jcfg, cfg, {"tokens": toks[:, :-1],
                                        "labels": toks[:, 1:],
                                        "frame_embeds": _frames(T=12, seed=7)})
