"""Port parity: the decoder-only transformer (``models/transformer.py``:
dense, MoE with a sliding window, the VLM prefix) against the JAX
package's, on the JAX package's tiny parameters carried across by
``interop.params_from_jax`` (its decode caches by ``cache_from_jax``),
with inputs made with numpy from a seed.

``forward`` in f32 and bf16; ``decode_step`` step by step against the
JAX package's from the same cache, every layer's buffers compared after
each step, past the end of a sliding window's rolling buffer; ``prefill``
(its logits and the cache it builds, slot = pos % cache_len); the
rolling buffer against a full-length cache (the JAX package's
``test_swa_rolling_buffer_matches_full_cache``); the optimizer's decay
ranks of the stacked layers; one AdamW step of ``make_train_step``
(MoE, and tied embeddings).

Tolerances: f32 1e-5 of the largest magnitude compared (sums in another
order); bf16 0.05 × max(1, |ref|) (the two frameworks round at other
places), with the greedy tokens compared as well.
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
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402

TRANSFORMERS = ["mixtral-8x7b", "granite-8b", "gemma-7b", "phi3-mini-3.8b",
                "nemotron-4-15b", "pixtral-12b"]
F32_TOL = 1e-5
BF16_REL = 0.05
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _model(name, dtype="float32", n_layers=None):
    kw = {"dtype": dtype}
    if n_layers:
        kw["n_layers"] = n_layers
    jcfg = dataclasses.replace(jconfigs.tiny(jconfigs.get(name)), **kw)
    cfg = dataclasses.replace(configs.tiny(configs.get(name)), **kw)
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
    assert float(np.abs(g - w).max()) <= tol * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("name", TRANSFORMERS)
def test_forward_matches_jax(name):
    """Every layer under remat, as the JAX package's scanned body; the VLM
    with its patch-embedding prefix."""
    jcfg, cfg, jparams, params = _model(name)
    jcfg = dataclasses.replace(jcfg, remat=True)
    cfg = dataclasses.replace(cfg, remat=True)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    prefix = None
    if cfg.n_prefix_tokens:
        prefix = rng.standard_normal((2, cfg.n_prefix_tokens, 64)).astype(np.float32)
    want, waux = jtransformer.forward(
        jparams, jnp.asarray(toks), jcfg,
        prefix_embeds=None if prefix is None else jnp.asarray(prefix))
    got, aux = transformer.forward(
        params, torch.tensor(toks), cfg,
        prefix_embeds=None if prefix is None else torch.tensor(prefix))
    assert got.shape == (2, 20 + cfg.n_prefix_tokens, 64)
    _within(got, want, F32_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=F32_TOL,
                               atol=1e-8)


@pytest.mark.parametrize("name", ["nemotron-4-15b", "pixtral-12b"])
def test_forward_bf16_matches_jax(name):
    """Dense configs.  A bf16 MoE forward is ill-conditioned against any
    second evaluation: on these inputs tiny Mixtral's router flips an
    expert at one token between the JAX package's own scanned forward and
    its layer-by-layer evaluation (1.96 apart at that token, 0.05 of the
    largest elsewhere), and the port agrees with the latter; ``moe_ffn``
    in bf16 is held against JAX's on the same inputs in
    ``test_torch_moe.py``."""
    jcfg, cfg, jparams, params = _model(name, "bfloat16")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want, _ = jtransformer.forward(jparams, jnp.asarray(toks), jcfg)
    got, _ = transformer.forward(params, torch.tensor(toks), cfg)
    assert got.dtype == torch.bfloat16
    _within(got, want, BF16_REL)


def _caches_equal(cache, want, tol):
    assert cache["pos"] == want["pos"]
    assert len(cache["layers"]) == len(want["layers"])
    for g, w in zip(cache["layers"], want["layers"]):
        assert g.keys() == w.keys() == {"k", "v"}
        for k in g:
            assert g[k].dtype == w[k].dtype
            _within(g[k], w[k], tol)


@pytest.mark.parametrize("name,steps,context", [
    ("mixtral-8x7b", 40, 64),       # a 32-slot window buffer, wrapped
    ("granite-8b", 12, 16),         # a full-context cache
    ("pixtral-12b", 6, 8),
])
def test_decode_steps_match_jax(name, steps, context):
    jcfg, cfg, jparams, params = _model(name)
    Sc = api.decode_cache_len(cfg, context)
    assert Sc == japi.decode_cache_len(jcfg, context)
    jcache = japi.init_cache(jcfg, 2, Sc)
    cache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), cfg,
                                   device=CPU)
    _caches_equal(cache, api.init_cache(cfg, 2, Sc, device=CPU), 0)
    jstep = jax.jit(functools.partial(japi.decode_step, jcfg))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (steps, 2, 1))
    for s in range(steps):
        wl, jcache = jstep(jparams, jcache, jnp.asarray(toks[s], jnp.int32))
        gl, cache = api.decode_step(cfg, params, cache,
                                    torch.tensor(toks[s], dtype=torch.int32))
        assert gl.shape == (2, 1, cfg.vocab)
        _within(gl, wl, F32_TOL)
        _caches_equal(cache, interop.cache_from_jax(
            jax.tree.map(np.asarray, jcache), cfg, device=CPU), F32_TOL)
    assert cache["pos"] == steps


@pytest.mark.parametrize("name,S,cache_len", [
    ("mixtral-8x7b", 20, 32), ("mixtral-8x7b", 64, 32),
    ("granite-8b", 12, 16)])
def test_prefill_matches_jax(name, S, cache_len):
    """The prompt's logits and the cache: the last ``cache_len`` positions
    at slot pos % cache_len; then a decode step from that cache."""
    jcfg, cfg, jparams, params = _model(name)
    toks = np.random.default_rng(S).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    wl, wc = jtransformer.prefill(jparams, jnp.asarray(toks), jcfg, cache_len)
    gl, gc = transformer.prefill(params, torch.tensor(toks), cfg, cache_len)
    _within(gl, wl, F32_TOL)
    want = interop.cache_from_jax(jax.tree.map(np.asarray, wc), cfg, device=CPU)
    _caches_equal(gc, want, F32_TOL)
    assert gc["pos"] == S
    nxt = np.full((2, 1), 7, np.int32)
    wl2, _ = japi.decode_step(jcfg, jparams, wc, jnp.asarray(nxt))
    gl2, _ = api.decode_step(cfg, params, gc, torch.tensor(nxt))
    _within(gl2, wl2, F32_TOL)


def test_swa_rolling_buffer_matches_full_cache():
    """A window-sized rolling buffer decodes as a full-length cache: the
    positions beyond the window are masked either way."""
    _, cfg, _, params = _model("mixtral-8x7b")
    assert cfg.window == 32
    T = cfg.window + 12
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, T)).astype(np.int32)

    def run(cache_len):
        cache = api.init_cache(cfg, 1, cache_len, device=CPU)
        outs = []
        for i in range(T):
            lg, cache = api.decode_step(cfg, params, cache,
                                        torch.tensor(toks[:, i:i + 1]))
            outs.append(_np(lg[:, 0]))
        return np.stack(outs, 1)
    np.testing.assert_allclose(run(cfg.window), run(T), rtol=F32_TOL,
                               atol=F32_TOL)


def test_bf16_decode_matches_jax():
    jcfg, cfg, jparams, params = _model("granite-8b", "bfloat16")
    jcache = japi.init_cache(jcfg, 2, 16)
    cache = api.init_cache(cfg, 2, 16, device=CPU)
    jstep = jax.jit(functools.partial(japi.decode_step, jcfg))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (10, 2, 1))
    agree = 0
    for s in range(10):
        wl, jcache = jstep(jparams, jcache, jnp.asarray(toks[s], jnp.int32))
        gl, cache = api.decode_step(cfg, params, cache,
                                    torch.tensor(toks[s], dtype=torch.int32))
        assert gl.dtype == torch.bfloat16
        _within(gl, wl, BF16_REL)
        agree += int((_np(gl).argmax(-1) == _np(wl).argmax(-1)).sum())
    assert agree >= 18


def test_stacked_ndims_and_layout():
    """Every layer leaf is stacked in the JAX package's tree (one rank
    more), so the optimizer decays the layers' norm scales too."""
    jcfg, cfg, jparams, params = _model("mixtral-8x7b")
    nd = api.stacked_ndims(cfg, params)
    assert len(params["layers"]) == cfg.n_layers == 2
    for i, lp in enumerate(params["layers"]):
        assert nd["layers"][i]["ln1"]["scale"] == 2
        assert nd["layers"][i]["moe"]["wg"] == 4
        np.testing.assert_array_equal(
            lp["moe"]["router"].numpy(),
            np.asarray(jparams["layers"]["moe"]["router"][i]))
    assert nd["final_norm"]["scale"] == 1 and nd["embed"]["tok"] == 2
    mine = api.init_params(cfg, device="meta")
    assert [tuple(t.shape) for t in jax.tree.leaves(
        jax.tree.map(lambda t: t, mine, is_leaf=torch.is_tensor))] == \
        [tuple(t.shape) for t in jax.tree.leaves(
            jax.tree.map(lambda t: t, params, is_leaf=torch.is_tensor))]


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


@pytest.mark.parametrize("name", ["mixtral-8x7b", "gemma-7b"])
def test_train_step_matches_jax(name):
    jcfg, cfg, _, _ = _model(name)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    _train_step_matches_jax(jcfg, cfg, {"tokens": toks[:, :-1],
                                        "labels": toks[:, 1:]})
