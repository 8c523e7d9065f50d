"""Port parity for the nine language models beside RecurrentGemma (the
transformer's dense, MoE and VLM configs, xLSTM, the encoder-decoder):
``configs.tiny`` of each, on the JAX package's own random parameters
carried across by ``interop.params_from_jax``, with inputs made with
numpy from a seed.

Per config: ``forward_hidden``, ``loss_fn`` and every gradient leaf
against the JAX package's (one jitted JAX call a config, in a module-
scoped cache); the port's teacher-forced decode against its own forward
(the JAX package's ``test_decode_matches_forward``); greedy tokens from
``BatchServer`` (whisper: ``Generator.generate(frame_embeds=)``) equal to
the JAX package's; and the parameter counts of the full configs.

Tolerances: f32 1e-5 of the largest magnitude compared (sums in another
order), for every family: the MoE router's softmax and xLSTM's
exponential gates stay within it on these inputs.  Decode against
forward: 1e-4 in f32, as RecurrentGemma's (the chunked and the step
forms of xLSTM's recurrence, the attention's chunked and cached paths).
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
from repro.serving import serve_loop as jserve  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import api, encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

NEW = [n for n in jconfigs.ARCH_NAMES if n != "recurrentgemma-9b"]
F32_TOL = 1e-5
DECODE_TOL = 1e-4
CPU = "cpu"
B, S = 2, 24


def _cfgs(name, **kw):
    """(JAX config, port config): tiny ``name`` in f32, equal fields."""
    j = dataclasses.replace(jconfigs.tiny(jconfigs.get(name)),
                            dtype="float32", **kw)
    t = dataclasses.replace(configs.tiny(configs.get(name)),
                            dtype="float32", **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frame_embeds"] = rng.standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _model(name):
    """(JAX config, port config, JAX params, port params, batch, JAX
    hidden, JAX loss, JAX gradient in the port's layout)."""
    jcfg, cfg = _cfgs(name)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_jax(_tree_np(jparams), cfg, device=CPU)
    batch = _batch(cfg)
    jb = jax.tree.map(jnp.asarray, batch)

    def f(p):
        hid, _ = japi.forward_hidden(jcfg, p, jb)
        loss, _ = japi.loss_fn(jcfg, p, jb)
        return loss, hid
    (loss, hid), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jparams)
    return (jcfg, cfg, jparams, params, batch, np.asarray(hid), float(loss),
            interop.params_from_jax(_tree_np(grads), cfg, device=CPU))


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_every_config_is_registered_with_the_jax_packages_fields():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert configs.names() == sorted(jconfigs.ARCH_NAMES)
    for name in configs.ARCH_NAMES:
        assert api.module_for(configs.get(name)).__name__.startswith(
            "repro_torch.models.")


@pytest.mark.parametrize("name", NEW)
def test_forward_hidden_matches_jax(name):
    _, cfg, _, params, batch, want, _, _ = _model(name)
    got, aux = api.forward_hidden(cfg, params, _tb(batch))
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.dim() == 0
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(_np(got) - want).max()) <= F32_TOL * scale


@pytest.mark.parametrize("name", NEW)
def test_loss_and_every_gradient_leaf_match_jax(name):
    _, cfg, _, params, batch, _, want_loss, want = _model(name)
    loss, grads = train_loop.make_loss_and_grad(cfg)(params, _tb(batch))
    assert abs(float(loss) - want_loss) <= F32_TOL * abs(want_loss)
    want = dict(_paths(want))
    got = dict(_paths(grads))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = _np(want[path])
        assert tuple(g.shape) == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(_np(g) - w).max()) <= F32_TOL * scale, path


@pytest.mark.parametrize("name", NEW)
def test_decode_matches_forward(name):
    """Teacher-forced decode over a cache reproduces the full-sequence
    logits (vlm on text only, as the JAX package's test)."""
    _, cfg, _, params, batch, _, _, _ = _model(name)
    toks = batch["tokens"][:, :10]
    if cfg.family == "audio":
        mod = api.module_for(cfg)
        enc = mod.encode(params, torch.tensor(batch["frame_embeds"]), cfg)
        hid = mod.decode_train(params, enc, torch.tensor(toks), cfg)
        cache = encdec.build_cache(params, enc, cfg, B, 16)
    else:
        hid, _ = api.forward_hidden(cfg, params, {"tokens": torch.tensor(toks)})
        cache = api.init_cache(cfg, B, api.decode_cache_len(cfg, 16),
                               device=CPU)
    want = _np(L.unembed(params["embed"], hid, cfg))
    got = []
    for i in range(toks.shape[1]):
        logits, cache = api.decode_step(cfg, params, cache,
                                        torch.tensor(toks[:, i:i + 1]))
        got.append(_np(logits[:, 0]))
    np.testing.assert_allclose(np.stack(got, axis=1), want, rtol=DECODE_TOL,
                               atol=DECODE_TOL)


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_param_counts_of_the_full_configs_match_jax(name):
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    assert api.param_count(cfg) == japi.param_count(jcfg)
    assert api.active_param_count(cfg) == japi.active_param_count(jcfg)
    if name == "mixtral-8x7b":
        assert api.param_count(cfg) == 46_702_792_704


@pytest.mark.parametrize("name", NEW)
def test_applicable_matches_jax(name):
    from repro.configs.shapes import SHAPES as JSHAPES, applicable as japp
    for sname, shape in configs.SHAPES.items():
        assert configs.applicable(configs.get(name), shape) == \
            japp(jconfigs.get(name), JSHAPES[sname])


def _prompts(n, vocab, seed, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("name", NEW)
def test_greedy_serving_matches_jax(name):
    """``BatchServer`` waves (whisper: ``Generator`` with frame
    embeddings), token for token with the JAX package's."""
    jcfg, cfg, jparams, params, _, _, _, _ = _model(name)
    if cfg.family == "audio":
        prompts = np.stack([p[:5] for p in _prompts(2, cfg.vocab, 3, 5, 5)])
        frames = np.random.default_rng(4).standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
        want = jserve.Generator(jcfg, jparams, jserve.GenConfig(
            max_new_tokens=6)).generate(prompts, frame_embeds=frames)
        got = serve_loop.Generator(cfg, params, serve_loop.GenConfig(
            max_new_tokens=6)).generate(prompts, frame_embeds=frames)
        assert got.shape == (2, 11)
        np.testing.assert_array_equal(got, want)
        return
    prompts = _prompts(3, cfg.vocab, 2)
    js = jserve.BatchServer(jcfg, jparams, batch_size=3,
                            gen=jserve.GenConfig(max_new_tokens=6))
    ts = serve_loop.BatchServer(cfg, params, batch_size=3,
                                gen=serve_loop.GenConfig(max_new_tokens=6))
    for p in prompts:
        assert js.submit(p, 6) == ts.submit(p, 6)
    want, got = js.run_until_drained(), ts.run_until_drained()
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for uid in want:
        np.testing.assert_array_equal(got[uid].result, want[uid].result)


def test_audio_generation_needs_frames():
    _, cfg, _, params, _, _, _, _ = _model("whisper-small")
    with pytest.raises(ValueError, match="frame_embeds"):
        serve_loop.Generator(cfg, params).generate(np.zeros((1, 3), np.int32))


def test_build_cache_matches_jax():
    """The cross K/V cache from the encoder output, layer by layer."""
    jcfg, cfg, jparams, params, batch, _, _, _ = _model("whisper-small")
    frames = batch["frame_embeds"]
    jenc = jencdec.encode(jparams, jnp.asarray(frames), jcfg)
    want = interop.cache_from_jax(_tree_np(jencdec.build_cache(
        jparams, jenc, jcfg, B, 8)), cfg, device=CPU)
    enc = encdec.encode(params, torch.tensor(frames), cfg)
    got = encdec.build_cache(params, enc, cfg, B, 8)
    assert got["pos"] == want["pos"] == 0
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            scale = max(1.0, float(w[k].abs().max()))
            assert float((g[k] - w[k]).abs().max()) <= F32_TOL * scale


def test_launch_serve_and_train_on_a_transformer(capsys):
    done = serve_cli.main(["--arch", "granite-8b", "--requests", "3",
                           "--batch-size", "2", "--prompt-len", "6",
                           "--max-new", "4", "--device", "cpu"])
    assert sorted(done) == [1, 2, 3]
    assert all(len(r.result) == 4 for r in done.values())
    losses = train_cli.main(["--arch", "xlstm-1.3b", "--preset", "smoke",
                             "--device", "cpu", "--steps", "2",
                             "--seq-len", "32", "--global-batch", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "served 3 requests, 12 new tokens" in out and "done: 2 steps" in out
    with pytest.raises(SystemExit, match="frame_embeds"):
        serve_cli.main(["--arch", "whisper-small", "--device", "cpu"])
