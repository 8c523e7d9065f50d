"""Port parity: K6, the causal depthwise conv1d, and the Griffin temporal
conv that calls it, against the JAX package (its Pallas kernel in
interpret mode, ``kernels/conv1d/ops.causal_conv1d``, and
``models/griffin.causal_conv(use_pallas=True)``).

The CUDA kernel runs only on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``); on CPU tensors the entry point runs its plain
version, which these tests hold against JAX, together with the
dispatch rules of ``griffin.causal_conv(use_kernel=...)`` and the build
cache key of the kernel sources.

Tolerances: f32 1e-5 as ``tests/test_conv1d_kernel.py`` (the same taps
in another order of rounding); bf16 3e-2, that file's own: the JAX kernel
adds in bf16, the port in f32 with one rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.conv1d.ops import causal_conv1d as jax_causal_conv1d  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv1d import conv1d, ops, ref  # noqa: E402
from repro_torch.models import griffin  # noqa: E402

SHAPES = [
    (2, 32, 16, 4),
    (1, 100, 24, 4),      # ragged T
    (3, 16, 128, 2),
    (2, 64, 8, 1),        # pointwise (no history)
    (1, 8, 16, 8),        # cw == T
]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("B,T,W,cw", SHAPES)
def test_plain_matches_jax_kernel(B, T, W, cw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, W)).astype(np.float32)
    w = rng.standard_normal((cw, W)).astype(np.float32)
    got = ops.causal_conv1d(torch.tensor(x), torch.tensor(w))
    want = jax_causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    assert got.shape == (B, T, W) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bf16():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    got = ops.causal_conv1d(torch.tensor(x).bfloat16(),
                            torch.tensor(w).bfloat16())
    want = jax_causal_conv1d(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_bf16_rounds_once():
    """The plain version rounds the f32 sum once: it equals the f32 conv of
    the same bf16 inputs, rounded."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((2, 40, 24)), dtype=torch.bfloat16)
    w = torch.tensor(rng.standard_normal((4, 24)), dtype=torch.bfloat16)
    want = ref.causal_conv1d_ref(x.float(), w.float()).bfloat16()
    assert torch.equal(ref.causal_conv1d_ref(x, w), want)


def test_causality():
    """Future inputs must not affect past outputs."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((1, 32, 8)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((4, 8)), dtype=torch.float32)
    y1 = ops.causal_conv1d(x, w)
    x2 = x.clone()
    x2[:, 20:] = 123.0
    y2 = ops.causal_conv1d(x2, w)
    assert torch.equal(y1[:, :20], y2[:, :20])
    assert not torch.equal(y1[:, 20:], y2[:, 20:])


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_griffin_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    state = rng.standard_normal((2, 3, 16)).astype(np.float32) \
        if with_state else None
    want_y, want_st = jgriffin.causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state), use_pallas=True)
    t = torch.tensor
    for use_kernel in (None, False):
        y, st = griffin.causal_conv(t(x), t(w), t(b),
                                    None if state is None else t(state),
                                    use_kernel=use_kernel)
        np.testing.assert_allclose(_np(y), np.asarray(want_y), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(st), np.asarray(want_st))


def test_griffin_causal_conv_decode_shape():
    """At decode (S = 1, state of cw-1 rows) the conv runs over cw rows
    and returns the last cw-1 inputs as the new state."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((3, 1, 8)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((4, 8)), dtype=torch.float32)
    b = torch.zeros(8)
    state = torch.tensor(rng.standard_normal((3, 3, 8)), dtype=torch.float32)
    y, st = griffin.causal_conv(x, w, b, state)
    full = torch.cat([state, x], dim=1)
    want = sum(full[:, k:k + 1] * w[k] for k in range(4))
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(st, full[:, 1:])


def test_use_kernel_true_raises_on_cpu():
    x = torch.zeros((1, 4, 8))
    w = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        griffin.causal_conv(x, w, torch.zeros(8), use_kernel=True)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        conv1d.causal_conv1d_cuda(x, w)


def test_entry_counts_plain_calls_and_no_launch_on_cpu():
    x = torch.zeros((1, 4, 8))
    w = torch.zeros((4, 8))
    calls, launches = ref.causal_conv1d_ref.calls, conv1d.causal_conv1d_cuda.launches
    ops.causal_conv1d(x, w)
    griffin.causal_conv(x, w, torch.zeros(8), use_kernel=False)
    assert ref.causal_conv1d_ref.calls == calls + 2
    assert conv1d.causal_conv1d_cuda.launches == launches


@pytest.mark.parametrize("bad", ["rank", "width", "dtype", "mixed", "strided"])
def test_entry_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((2, 6, 8))
    w = torch.zeros((4, 8))
    if bad == "rank":
        x = x[0]
    elif bad == "width":
        w = torch.zeros((4, 9))
    elif bad == "dtype":
        x, w = x.double(), w.double()
    elif bad == "mixed":
        w = w.bfloat16()
    else:
        x = torch.zeros((2, 8, 6)).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        ops.causal_conv1d(x, w)


def test_source_reads_its_include_directory():
    src = conv1d.source()
    assert src.include == _build.KERNELS / "conv1d" / "csrc"
    assert "rt_causal_conv1d" in src.text
    assert "__fmul_rn" in src.text         # no contraction, as the plain version


def test_cache_key_covers_the_include_directory(tmp_path, monkeypatch):
    """A header edit in a source's include directory changes its hash; a
    header elsewhere does not."""
    inc = tmp_path / "kern" / "csrc"
    inc.mkdir(parents=True)
    other = tmp_path / "other"
    other.mkdir()
    (inc / "a.cuh").write_text("// one\n")
    (other / "b.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "KERNELS", tmp_path)
    src = _build.Source('#include "a.cuh"\n', inc)
    h0 = _build.source_hash(src)
    (other / "b.cuh").write_text("// two\n")
    assert _build.source_hash(src) == h0
    (inc / "a.cuh").write_text("// two\n")
    assert _build.source_hash(src) != h0
    # the same text with another include directory is another library
    assert _build.source_hash(_build.Source(src.text, other)) != \
        _build.source_hash(src)


def test_plain_string_is_a_stencil_source():
    text = "// generated\n"
    assert _build.source_hash(text) == \
        _build.source_hash(_build.Source(text, _build.STENCIL_CSRC))
