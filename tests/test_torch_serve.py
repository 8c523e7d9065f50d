"""Port parity: serving (``serving/serve_loop``: ``Generator``,
``BatchServer``, ``make_serve_step``) against the JAX package's, greedy,
token for token, on the JAX package's tiny f32 RecurrentGemma parameters
carried across by ``interop.params_from_jax``; the parameter count of the
full ``recurrentgemma-9b``; and the CLI on the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import serve_loop as jserve  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = dataclasses.replace(jconfigs.tiny(jconfigs.get("recurrentgemma-9b")),
                               dtype="float32")
    cfg = dataclasses.replace(configs.tiny(configs.get("recurrentgemma-9b")),
                              dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(1))
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, cfg, jparams, params


def _prompts(n, lo=4, hi=16, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).astype(np.int32)
            for _ in range(n)]


def test_param_count_matches_the_jax_package():
    cfg = configs.get("recurrentgemma-9b")
    assert api.param_count(cfg) == 9_396_408_320
    assert api.param_count(cfg) == japi.param_count(jconfigs.get("recurrentgemma-9b"))
    tiny = configs.tiny(cfg)
    assert api.param_count(tiny) == japi.param_count(jconfigs.tiny(
        jconfigs.get("recurrentgemma-9b")))


def test_generator_greedy_matches_jax():
    jcfg, cfg, jparams, params = _model()
    prompts = np.stack([p[:6] for p in _prompts(3, lo=6, hi=6, seed=1)])
    gen = serve_loop.GenConfig(max_new_tokens=12)
    want = jserve.Generator(jcfg, jparams,
                            jserve.GenConfig(max_new_tokens=12)).generate(prompts)
    g = serve_loop.Generator(cfg, params, gen)
    got = g.generate(prompts)
    assert got.dtype == want.dtype and got.shape == (3, 18)
    np.testing.assert_array_equal(got, want)
    assert g.cache["pos"] == 17                  # 16-slot buffer wrapped


def test_batch_server_greedy_matches_jax():
    jcfg, cfg, jparams, params = _model()
    prompts = _prompts(8, seed=2)
    js = jserve.BatchServer(jcfg, jparams, batch_size=4,
                            gen=jserve.GenConfig(max_new_tokens=8))
    ts = serve_loop.BatchServer(cfg, params, batch_size=4,
                                gen=serve_loop.GenConfig(max_new_tokens=8))
    for i, p in enumerate(prompts):
        assert js.submit(p, 8 - (i % 3)) == ts.submit(p, 8 - (i % 3))
    want, got = js.run_until_drained(), ts.run_until_drained()
    assert sorted(got) == sorted(want) == list(range(1, 9))
    for uid in want:
        assert len(got[uid].result) == 8 - ((uid - 1) % 3)
        np.testing.assert_array_equal(got[uid].result, want[uid].result)
        assert got[uid].done_at >= got[uid].submitted_at


def test_serve_step_logits_and_greedy():
    jcfg, cfg, jparams, params = _model()
    step = serve_loop.make_serve_step(cfg, sample=False)
    cache = api.init_cache(cfg, 2, 8, device="cpu")
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    logits, cache2 = step(params, cache, tok)
    assert logits.shape == (2, 256) and logits.dtype == torch.float32
    assert cache2["pos"] == 1
    greedy = serve_loop.make_serve_step(cfg)
    nxt, _ = greedy(params, api.init_cache(cfg, 2, 8, device="cpu"), tok)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], logits.argmax(-1).to(torch.int32))


def test_temperature_sampling_is_seeded():
    _, cfg, _, params = _model()
    prompts = np.stack(_prompts(2, lo=5, hi=5, seed=3))

    def run(seed):
        return serve_loop.Generator(cfg, params, serve_loop.GenConfig(
            max_new_tokens=10, temperature=1.0, seed=seed)).generate(prompts)
    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < cfg.vocab)).all()


def test_cli_serves_on_the_cpu(capsys):
    done = serve_cli.main(["--requests", "3", "--batch-size", "2",
                           "--prompt-len", "6", "--max-new", "4",
                           "--device", "cpu"])
    assert sorted(done) == [1, 2, 3]
    assert all(len(r.result) == 4 for r in done.values())
    out = capsys.readouterr().out
    assert "served 3 requests, 12 new tokens" in out and "on cpu" in out
