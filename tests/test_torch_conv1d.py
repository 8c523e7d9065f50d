"""Port parity: K6, the causal depthwise conv1d, its gradient
(``ops.CausalConv1dFn``) and the Griffin temporal conv that calls it,
against the JAX package (its Pallas kernel in interpret mode,
``kernels/conv1d/ops.causal_conv1d``, ``models/griffin.causal_conv(
use_pallas=True)``, and ``jax.grad`` of the jnp conv its training
differentiates).

The CUDA kernel runs only on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``); on CPU tensors the entry point runs its plain
version, which these tests hold against JAX, together with the
dispatch rules of ``griffin.causal_conv(use_kernel=...)``, the choice of
the kernel's build (``conv1d.build_of``) and the build cache key of the
kernel sources.

Tolerances: f32 1e-5 as ``tests/test_conv1d_kernel.py`` (the same taps
in another order of rounding); bf16 3e-2, that file's own: the JAX kernel
adds in bf16, the port in f32 with one rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import jax  # noqa: E402

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


def test_entry_rejects_widths_above_the_build():
    """The kernel's register queue is built for 1 ≤ cw ≤ 8; the entry
    refuses wider convs on every device, as the card would."""
    x = torch.zeros((1, 16, 8))
    ops.causal_conv1d(x, torch.zeros((conv1d.MAX_WIDTH, 8)))
    with pytest.raises(ValueError, match="cw <= 8"):
        ops.causal_conv1d(x, torch.zeros((conv1d.MAX_WIDTH + 1, 8)))
    with pytest.raises(ValueError):
        ops.causal_conv1d(x, torch.zeros((0, 8)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_build_of(dtype):
    """The vector build takes widths that fill 16-byte vectors on 16-byte
    aligned bases; the lane build the rest (a ragged width, a base off
    the boundary)."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    x = torch.zeros((2, 5, 4 * vec), dtype=dtype)
    w = torch.zeros((4, 4 * vec), dtype=dtype)
    y = torch.empty_like(x)
    assert x.data_ptr() % 16 == w.data_ptr() % 16 == y.data_ptr() % 16 == 0
    assert conv1d.build_of(x, w, y) == "vector"
    ragged = torch.zeros((2, 5, 4 * vec + 1), dtype=dtype)
    assert conv1d.build_of(ragged, torch.zeros((4, 4 * vec + 1), dtype=dtype),
                           torch.empty_like(ragged)) == "lane"
    flat = torch.zeros(2 * 5 * 4 * vec + 1, dtype=dtype)
    off = flat[1:].view(2, 5, 4 * vec)            # one element past the base
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    assert conv1d.build_of(off, w, y) == "lane"


@pytest.mark.parametrize("cw", [1, 2, 4])
def test_autograd_fn_gradcheck_f64(cw, monkeypatch):
    """The gradient of ``CausalConv1dFn`` (dx: the conv of the reversed
    cotangent, reversed; dw: the f32 reduction) against finite differences
    in f64, with the plain version in place of the entry (which takes f32
    and bf16 only)."""
    monkeypatch.setattr(ops, "causal_conv1d", ref.causal_conv1d_ref)
    rng = np.random.default_rng(cw)
    x = torch.tensor(rng.standard_normal((2, 9, 5)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((cw, 5)), requires_grad=True)
    assert torch.autograd.gradcheck(ops.CausalConv1dFn.apply, (x, w))


def test_weight_grad_is_the_reduction_autograd_takes():
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((3, 11, 6)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((4, 6)), dtype=torch.float32,
                     requires_grad=True)
    g = torch.tensor(rng.standard_normal((3, 11, 6)), dtype=torch.float32)
    (want,) = torch.autograd.grad(ref.causal_conv1d_ref(x, w), w, g)
    torch.testing.assert_close(ops.weight_grad(x, g, 4), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_griffin_causal_conv_grad_matches_jax(dtype):
    """dx, dw and db of the full-sequence temporal conv (``CausalConv1dFn``
    under autograd) against ``jax.grad`` of the JAX package's jnp conv, on
    f32 parameters cast to the compute dtype as the model does."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 30, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    ct = rng.standard_normal((2, 30, 16)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jloss(x, w, b):
        y, _ = jgriffin.causal_conv(x, w, b)
        return (y.astype(jnp.float32) * ct).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x, jdt),
                                              jnp.asarray(w), jnp.asarray(b))
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    tw = torch.tensor(w).requires_grad_(True)
    tb = torch.tensor(b).requires_grad_(True)
    n = ref.causal_conv1d_ref.calls
    y, _ = griffin.causal_conv(tx, tw, tb)
    got = torch.autograd.grad((y.float() * torch.tensor(ct)).sum(), (tx, tw, tb))
    assert ref.causal_conv1d_ref.calls == n + 2        # forward and dx
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    for g_, w_ in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(w_, np.float32)).max()))
        tol = 1e-5 if dtype == "float32" else 3e-2
        assert float(np.abs(_np(g_) - np.asarray(w_, np.float32)).max()) \
            <= tol * scale
