"""Port parity: the Griffin / RecurrentGemma decode and full-sequence paths
(``models/layers``, ``models/griffin``, ``models/api``) against the JAX
package, on the JAX package's own random parameters carried across by
``interop.params_from_jax`` (the decode caches by ``cache_from_jax``).

Each layer function is held against its JAX twin on the same inputs (the
full-sequence ones too: ``rg_lru_scan``, ``rec_mix`` without a state,
``_sdpa_chunked``, ``forward``, and the port's decode against its own
forward); then
``decode_step`` runs 20 steps on ``configs.tiny(recurrentgemma-9b)``, so
that its 16-slot local-attention buffer wraps, comparing logits and every
layer's cache after each step; and the same for a config with a tail
(8 layers: two full cycles and a (rec, rec) tail).  The recurrent conv
runs K6's plain version here (CPU tensors); the card runs the kernel
(``chip_smoke.py``).

Tolerances: f32 1e-5 (a few ulp of the values compared, from sums in
another order); bf16, where the two frameworks round at other places
(XLA fuses elementwise chains, PyTorch rounds each op), 0.05 of the
largest magnitude compared (the gap reads 1.2–1.5 % of it on these
inputs), with the greedy tokens compared as well.
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
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import api, griffin  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

F32_TOL = 1e-5
BF16_REL = 0.05
CPU = "cpu"


def _cfgs(dtype="float32", **kw):
    """(JAX config, port config): tiny recurrentgemma-9b, equal fields."""
    j = dataclasses.replace(jconfigs.tiny(jconfigs.get("recurrentgemma-9b")),
                            dtype=dtype, **kw)
    t = dataclasses.replace(configs.tiny(configs.get("recurrentgemma-9b")),
                            dtype=dtype, **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _model(dtype="float32", n_layers=None):
    kw = {} if n_layers is None else {"n_layers": n_layers}
    jcfg, cfg = _cfgs(dtype, **kw)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_jax(_tree_np(jparams), cfg, device=CPU)
    return jcfg, cfg, jparams, params


def test_configs_are_the_jax_packages():
    assert configs.names() == jconfigs.names()
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for name in configs.ARCH_NAMES:
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(jconfigs.get(name)), name
        assert dataclasses.asdict(configs.tiny(configs.get(name))) == \
            dataclasses.asdict(jconfigs.tiny(jconfigs.get(name))), name


def test_params_from_jax_unstacks_layers_in_order():
    jcfg, cfg, jparams, params = _model()
    assert len(params["blocks"]) == cfg.n_layers == 6
    types = griffin.block_types(cfg)
    assert types == jgriffin.block_types(jcfg)
    for i, (bp, t) in enumerate(zip(params["blocks"], types)):
        c, p = divmod(i, 3)
        want = jparams["cycles"][str(p)]
        if t == "rec":
            _close(bp["mix"]["wa"], want["mix"]["wa"][c], 0)
        else:
            _close(bp["mix"]["attn"]["wq"], want["mix"]["attn"]["wq"][c], 0)
        _close(bp["ffn"]["mlp"]["wo"], want["ffn"]["mlp"]["wo"][c], 0)
    # the shapes (and so the count) are those of the port's own init
    mine = api.init_params(cfg, device="meta")
    for a, b in zip(jax.tree.leaves(jax.tree.map(
            lambda t: tuple(t.shape), params, is_leaf=torch.is_tensor)),
            jax.tree.leaves(jax.tree.map(
                lambda t: tuple(t.shape), mine, is_leaf=torch.is_tensor))):
        assert a == b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    s = rng.standard_normal((64,)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x, jdt))
    got = L.rmsnorm({"scale": torch.tensor(s)}, torch.tensor(x).to(tdt))
    assert got.dtype == tdt
    _close(got, want, F32_TOL if dtype == "float32" else 2e-2)


def test_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = L.rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    # angles up to 3000 rad: sin/cos of a large f32 argument differ by a
    # few ulp of the argument between the two libraries
    _close(got, want, 2e-4)
    small = torch.tensor(pos % 64)
    _close(L.rope(torch.tensor(x), small, 10000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos % 64), 10000.0))


def test_softplus_matches_at_the_gate_values():
    """``jax.nn.softplus`` is logaddexp(x, 0); ``F.softplus`` switches to x
    above 20.  They agree in f32 over the range a decay parameter takes."""
    lam = np.concatenate([np.linspace(-30, 30, 601), [2.0, 19.99, 20.0, 20.01,
                                                      40.0]]).astype(np.float32)
    want = jax.nn.softplus(jnp.asarray(lam))
    got = torch.nn.functional.softplus(torch.tensor(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("pos", [5, 21], ids=["prefix", "wrapped"])
def test_attention_with_cache(pos):
    jcfg, cfg, jparams, params = _model()
    rng = np.random.default_rng(2)
    B, Sc = 2, 16
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    kc = rng.standard_normal((B, Sc, 1, 16)).astype(np.float32)
    vc = rng.standard_normal((B, Sc, 1, 16)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["cycles"]["2"]["mix"]["attn"])
    positions = np.full((B, 1), pos, np.int32)
    want, wc = JL.attention(jp, jnp.asarray(x), jcfg, mode="causal",
                            window=jcfg.local_window,
                            positions=jnp.asarray(positions),
                            cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc),
                                   "pos": jnp.int32(pos)})
    cache = {"k": torch.tensor(kc), "v": torch.tensor(vc), "pos": pos}
    got, nc = L.attention(params["blocks"][2]["mix"]["attn"], torch.tensor(x),
                          cfg, mode="causal", window=cfg.local_window,
                          positions=torch.tensor(positions), cache=cache)
    _close(got, want)
    _close(nc["k"], wc["k"])
    _close(nc["v"], wc["v"])
    assert nc["pos"] == int(wc["pos"]) == pos + 1


def test_attention_full_sequence():
    jcfg, cfg, jparams, params = _model()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["cycles"]["2"]["mix"]["attn"])
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, mode="causal",
                           window=jcfg.local_window)
    got, _ = L.attention(params["blocks"][5]["mix"]["attn"], torch.tensor(x),
                         cfg, mode="causal", window=cfg.local_window)
    _close(got, want)


def test_mlp_embed_unembed():
    jcfg, cfg, jparams, params = _model()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["cycles"]["0"]["ffn"]["mlp"])
    _close(L.mlp(params["blocks"][0]["ffn"]["mlp"], torch.tensor(x), cfg),
           JL.mlp(jp, jnp.asarray(x), jcfg))
    toks = rng.integers(0, cfg.vocab, (2, 3)).astype(np.int32)
    _close(L.embed(params["embed"], torch.tensor(toks), cfg),
           JL.embed(jparams["embed"], jnp.asarray(toks), jcfg), 0)
    _close(L.unembed(params["embed"], torch.tensor(x), cfg),
           JL.unembed(jparams["embed"], jnp.asarray(x), jcfg))


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 121).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.tensor(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_rg_lru_step_and_rec_mix_with_state():
    jcfg, cfg, jparams, params = _model()
    rng = np.random.default_rng(5)
    B = 3
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    h = rng.standard_normal((B, 64)).astype(np.float32)
    conv = rng.standard_normal((B, 3, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["cycles"]["1"]["mix"])
    # a non-trivial decay parameter and biases
    lam = rng.uniform(-3, 6, 64).astype(np.float32)
    ba = rng.standard_normal(64).astype(np.float32)
    jp = dict(jp, lam=jnp.asarray(lam), ba=jnp.asarray(ba))
    p = dict(params["blocks"][4]["mix"], lam=torch.tensor(lam),
             ba=torch.tensor(ba))
    wy, wh = jgriffin.rg_lru_step(jp, jnp.asarray(x), jnp.asarray(h))
    gy, gh = griffin.rg_lru_step(p, torch.tensor(x), torch.tensor(h))
    _close(gy, wy)
    _close(gh, wh)
    want, wst = jgriffin.rec_mix(jp, jnp.asarray(x), jcfg,
                                 state={"h": jnp.asarray(h),
                                        "conv": jnp.asarray(conv)},
                                 use_pallas_conv=True)
    got, gst = griffin.rec_mix(p, torch.tensor(x), cfg,
                               state={"h": torch.tensor(h),
                                      "conv": torch.tensor(conv)})
    _close(got, want)
    _close(gst["h"], wst["h"])
    _close(gst["conv"], wst["conv"])


def _rec_params(jparams, params, layer=4, seed=9):
    """Layer ``layer``'s recurrent mix in both layouts, with a non-trivial
    decay parameter and biases."""
    rng = np.random.default_rng(seed)
    c, pos = divmod(layer, 3)
    jp = jax.tree.map(lambda a: a[c], jparams["cycles"][str(pos)]["mix"])
    extra = {"lam": rng.uniform(-3, 6, 64).astype(np.float32),
             "ba": rng.standard_normal(64).astype(np.float32),
             "conv_b": rng.standard_normal(64).astype(np.float32)}
    jp = dict(jp, **{k: jnp.asarray(v) for k, v in extra.items()})
    p = dict(params["blocks"][layer]["mix"],
             **{k: torch.tensor(v) for k, v in extra.items()})
    return jp, p


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_rg_lru_scan_matches_jax(S):
    """The associative scan over time, even and odd lengths (the
    recursion's two branches) and S = 1."""
    jcfg, cfg, jparams, params = _model()
    jp, p = _rec_params(jparams, params)
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(np.float32)
    want = jgriffin.rg_lru_scan(jp, jnp.asarray(x))
    got = griffin.rg_lru_scan(p, torch.tensor(x))
    assert got.shape == (2, S, 64) and got.dtype == torch.float32
    _close(got, want)
    # the scan is the recurrence h_t = a_t h_{t-1} + b_t from h = 0
    a, b = griffin._rg_lru_gates(p, torch.tensor(x))
    h, hs = torch.zeros(2, 64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    _close(got, torch.stack(hs, dim=1))


def test_rec_mix_without_state_is_not_ported():
    """``rec_mix`` without a state, once not ported, is the full-sequence
    path: the conv over ``[B, S+cw-1, W]`` and ``rg_lru_scan``, held
    against the JAX package's (f32; the conv through K6's plain version and
    through the JAX Pallas kernel in interpret mode)."""
    jcfg, cfg, jparams, params = _model()
    jp, p = _rec_params(jparams, params)
    x = np.random.default_rng(10).standard_normal((2, 19, 64)).astype(np.float32)
    want, wst = jgriffin.rec_mix(jp, jnp.asarray(x), jcfg,
                                 use_pallas_conv=True)
    for use_kernel in (None, False):
        got, st = griffin.rec_mix(p, torch.tensor(x), cfg,
                                  use_kernel_conv=use_kernel)
        assert st is None and wst is None
        _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,window,Sk,chunk", [
    ("causal", 16, 20, 8),        # ragged: 4 padded keys in the last chunk
    ("causal", None, 24, 8),
    ("bidir", None, 13, 5),
    ("causal", 6, 16, 16),        # one chunk
])
def test_sdpa_chunked_matches_jax(dtype, mode, window, Sk, chunk):
    rng = np.random.default_rng(Sk + chunk)
    B, H, K, D = 2, 4, 2, 16
    q = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, K, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    args = (mode, window, D ** -0.5, chunk)
    want = JL._sdpa_chunked(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            jnp.asarray(pos), jnp.asarray(pos), *args)
    got = L._sdpa_chunked(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                          torch.tensor(pos), torch.tensor(pos), *args)
    assert got.shape == (B, Sk, H, D) and got.dtype == tdt
    _close(got, want, F32_TOL if dtype == "float32" else 2e-2)
    if dtype == "float32":          # the same as the unchunked softmax
        msk = L._mask(torch.tensor(pos), torch.tensor(pos), mode, window)
        _close(got, L._sdpa(*(torch.tensor(a) for a in (q, k, v)),
                            msk[:, None], D ** -0.5))


def test_attention_chunked_branch_matches_jax():
    jcfg, cfg, jparams, params = _model()
    jcfg = dataclasses.replace(jcfg, attn_chunk=8)
    cfg = dataclasses.replace(cfg, attn_chunk=8)
    x = np.random.default_rng(11).standard_normal((2, 21, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["cycles"]["2"]["mix"]["attn"])
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, mode="causal",
                           window=jcfg.local_window)
    got, _ = L.attention(params["blocks"][2]["mix"]["attn"], torch.tensor(x),
                         cfg, mode="causal", window=cfg.local_window)
    _close(got, want)


@pytest.mark.parametrize("dtype,n_layers,attn_chunk", [
    ("float32", None, None), ("float32", 8, 8), ("bfloat16", None, 8)],
    ids=["f32", "f32-tail-chunked", "bf16-chunked"])
def test_forward_matches_jax(dtype, n_layers, attn_chunk):
    """The full-sequence forward (each full cycle checkpointed, as the JAX
    package's scanned body) on the same parameters and tokens."""
    jcfg, cfg, jparams, params = _model(dtype, n_layers)
    jcfg = dataclasses.replace(jcfg, attn_chunk=attn_chunk, remat=True)
    cfg = dataclasses.replace(cfg, attn_chunk=attn_chunk, remat=True)
    toks = np.random.default_rng(12).integers(0, 256, (2, 20)).astype(np.int32)
    want, waux = jgriffin.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = griffin.forward(params, torch.tensor(toks), cfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 20, 64)
    assert float(aux) == float(waux) == 0.0
    if dtype == "float32":
        _close(got, want)
    else:
        g, w = _np(got), _np(want)
        assert np.abs(g - w).max() <= BF16_REL * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_forward(dtype):
    """Teacher-forced decode over a cache reproduces the full-sequence
    forward's logits (the JAX package's ``test_decode_matches_forward``:
    0.15 and argmax agreement over 0.95 in bf16; f32 here to 1e-4)."""
    _, cfg, _, params = _model(dtype)
    toks = np.random.default_rng(13).integers(0, 256, (2, 8)).astype(np.int32)
    hid, _ = api.forward_hidden(cfg, params, {"tokens": torch.tensor(toks)})
    want = _np(L.unembed(params["embed"], hid, cfg))
    cache = api.init_cache(cfg, 2, api.decode_cache_len(cfg, 16), device=CPU)
    got = []
    for i in range(toks.shape[1]):
        logits, cache = api.decode_step(cfg, params, cache,
                                        torch.tensor(toks[:, i:i + 1]))
        got.append(_np(logits[:, 0]))
    got = np.stack(got, axis=1)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0.15, atol=0.15)
        assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.95


def _run_decode(dtype, n_layers, steps, B=2, seed=6):
    """Run ``steps`` decode steps through both packages from the same
    caches; yields (step, port logits, JAX logits, port cache, JAX cache
    carried across)."""
    jcfg, cfg, jparams, params = _model(dtype, n_layers)
    Sc = api.decode_cache_len(cfg, 64)
    assert Sc == japi.decode_cache_len(jcfg, 64) == 16
    jcache = japi.init_cache(jcfg, B, Sc)
    cache = interop.cache_from_jax(_tree_np(jcache), cfg, device=CPU)
    jstep = jax.jit(functools.partial(japi.decode_step, jcfg))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (steps, B, 1))
    for s in range(steps):
        wl, jcache = jstep(jparams, jcache, jnp.asarray(toks[s], jnp.int32))
        gl, cache = api.decode_step(cfg, params, cache,
                                    torch.tensor(toks[s], dtype=torch.int32))
        yield s, gl, wl, cache, interop.cache_from_jax(_tree_np(jcache), cfg,
                                                       device=CPU)


def _compare_caches(cache, want, tol):
    assert cache["pos"] == want["pos"]
    for got_b, want_b in zip(cache["blocks"], want["blocks"]):
        assert got_b.keys() == want_b.keys()
        for name in got_b:
            assert got_b[name].dtype == want_b[name].dtype
            _close(got_b[name], want_b[name], tol)


@pytest.mark.parametrize("n_layers", [None, 8], ids=["tiny", "tail"])
def test_decode_step_f32_20_steps(n_layers):
    seen = 0
    for s, got, want, cache, wcache in _run_decode("float32", n_layers, 20):
        assert got.shape == (2, 1, 256) and got.dtype == torch.float32
        _close(got, want)
        _compare_caches(cache, wcache, F32_TOL)
        seen += 1
    assert seen == 20 and cache["pos"] == 20          # 16 slots wrapped


@pytest.mark.parametrize("n_layers", [None, 8], ids=["tiny", "tail"])
def test_decode_step_bf16_20_steps(n_layers):
    agree = total = 0
    for s, got, want, cache, wcache in _run_decode("bfloat16", n_layers, 20):
        assert got.dtype == torch.bfloat16
        g, w = _np(got), _np(want)
        assert np.isfinite(g).all()
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= BF16_REL * scale, s
        agree += int((g.argmax(-1) == w.argmax(-1)).sum())
        total += g.shape[0]
        for got_b, want_b in zip(cache["blocks"], wcache["blocks"]):
            for name in got_b:
                a, b = _np(got_b[name]), _np(want_b[name])
                assert np.abs(a - b).max() <= BF16_REL * max(1.0, np.abs(b).max())
    assert agree >= 0.9 * total, (agree, total)


def test_block_types_and_cycle_split():
    for n in (6, 8, 38):
        jcfg, cfg = _cfgs(n_layers=n)
        assert griffin.block_types(cfg) == jgriffin.block_types(jcfg)
        assert griffin._cycle_split(cfg) == jgriffin._cycle_split(jcfg)


def test_an_unknown_family_raises():
    cfg = dataclasses.replace(configs.tiny(configs.get("recurrentgemma-9b")),
                              family="diffusion")
    with pytest.raises(ValueError, match="unknown model family 'diffusion'"):
        api.module_for(cfg)
    with pytest.raises(ValueError, match="unknown model family"):
        api.init_params(cfg, device="meta")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.params_from_jax(_tree_np(_model()[2]), cfg)
