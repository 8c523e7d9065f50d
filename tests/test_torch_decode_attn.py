"""Port parity: K7, flash decode attention, against the JAX package's
Pallas kernel in interpret mode (``kernels/decode_attn/ops``), at that
package's test shapes (``tests/test_decode_attn_kernel.py``), in bf16,
under a corrupted masked tail, and against the model's attention
(``layers._sdpa``) on a decode cache, including a rolling buffer that has
wrapped.

The CUDA kernels run only on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``); on CPU tensors the entry point runs its plain
version.  The kernel splits the sequence over blocks and combines their
partials in a second pass; the plain versions of both passes
(``ref.split_ref``, ``ref.combine_ref``) run here on the kernel's own split
plan (``decode_attn.split_plan``), with lengths 0, 1, S and one past a
split boundary, against the JAX kernel and the plain whole function.  Tolerances: f32 2e-5 and bf16 3e-2, those of the JAX package's
test (f32 sums in another order; bf16 output rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn.ops import decode_attention as jax_decode_attention  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn, ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


def _mk(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    lengths = rng.integers(1, S + 1, (B,)).astype(np.int32)
    return q, k, v, lengths


def _torch(*arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


@pytest.mark.parametrize("B,S,H,K,hd,bs", [
    (2, 64, 8, 4, 16, 16),        # GQA 2:1 blocks
    (3, 100, 4, 1, 32, 32),       # MQA, ragged S
    (1, 33, 16, 16, 8, 8),        # MHA, odd S
    (2, 128, 8, 2, 16, 128),      # single block
    (4, 48, 8, 8, 64, 16),
])
def test_plain_matches_jax_kernel(B, S, H, K, hd, bs):
    q, k, v, lengths = _mk(B, S, H, K, hd)
    want = jax_decode_attention(*map(jnp.asarray, (q, k, v, lengths)),
                                block_s=bs)
    got = ops.decode_attention(*_torch(q, k, v), torch.tensor(lengths),
                               block_s=bs)
    assert got.shape == (B, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_bf16_inputs():
    q, k, v, lengths = _mk(2, 64, 8, 4, 32)
    want = jax_decode_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)),
                                jnp.asarray(lengths), block_s=32)
    got = ops.decode_attention(*_torch(q, k, v, dtype=torch.bfloat16),
                               torch.tensor(lengths), block_s=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_short_lengths_mask_everything_beyond():
    """Entries past ``lengths`` must not influence the output."""
    q, k, v, _ = _mk(2, 64, 8, 4, 16, seed=1)
    lengths = torch.tensor([5, 17], dtype=torch.int32)
    q, k, v = _torch(q, k, v)
    got = ops.decode_attention(q, k, v, lengths, block_s=16)
    k2, v2 = k.clone(), v.clone()
    k2[:, 32:] = 999.0
    v2[:, 32:] = -999.0
    got2 = ops.decode_attention(q, k2, v2, lengths, block_s=16)
    assert torch.equal(got, got2)
    want = jax_decode_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                jnp.asarray(lengths.numpy()), block_s=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_matches_model_attention_path():
    """Plain K7 == the port's ``_sdpa`` == the JAX package's on the same
    cache contents (positions 0..len-1, no window)."""
    B, S, H, K, hd = 2, 32, 8, 4, 16
    q, k, v, _ = _mk(B, S, H, K, hd, seed=2)
    lengths = torch.full((B,), S, dtype=torch.int32)
    qt, kt, vt = _torch(q, k, v)
    got = ops.decode_attention(qt, kt, vt, lengths, block_s=8)
    mask = torch.ones((B, 1, 1, S), dtype=torch.bool)
    sdpa = L._sdpa(qt[:, None], kt, vt, mask, hd ** -0.5)[:, 0]
    jsdpa = JL._sdpa(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                     jnp.ones((B, 1, 1, S), bool), hd ** -0.5)[:, 0]
    torch.testing.assert_close(got, sdpa, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(sdpa.numpy(), np.asarray(jsdpa), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("pos", [9, 15, 16, 40], ids=lambda p: f"pos{p}")
def test_rolling_buffer_lengths(pos):
    """On a rolling buffer of Sc slots, the valid slots for the query at
    ``pos`` are a prefix of ``min(pos + 1, Sc)`` slots until it wraps and
    all of them after: K7 with those lengths equals ``_sdpa`` under the
    mask ``attention`` builds (causal, window ≥ Sc)."""
    B, Sc, H, K, hd = 2, 16, 4, 1, 16
    q, k, v, _ = _mk(B, Sc, H, K, hd, seed=3)
    qt, kt, vt = _torch(q, k, v)
    positions = torch.full((B, 1), pos)
    k_pos = L.cache_abs_pos(pos, Sc, "cpu").expand(B, Sc)
    mask = L._mask(positions, k_pos, "causal", 2048)[:, None]
    assert int(mask.sum()) == B * min(pos + 1, Sc)
    want = L._sdpa(qt[:, None], kt, vt, mask, hd ** -0.5)[:, 0]
    lengths = torch.full((B,), min(pos + 1, Sc), dtype=torch.int32)
    got = ops.decode_attention(qt, kt, vt, lengths)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_cuda_launch_raises_on_cpu():
    q, k, v, lengths = _mk(1, 8, 2, 1, 8)
    before = decode_attn.decode_attention_cuda.launches
    with pytest.raises(ValueError, match="not on a CUDA device"):
        decode_attn.decode_attention_cuda(*_torch(q, k, v),
                                          torch.tensor(lengths))
    assert decode_attn.decode_attention_cuda.launches == before


@pytest.mark.parametrize("bad", ["heads", "dtype", "lengths", "head_dim",
                                 "smem", "head_dim_multiple", "group"])
def test_entry_rejects_what_the_kernel_does_not_take(bad):
    B, S, H, K, hd, bs = 1, 8, 4, 2, 8, 64
    if bad == "heads":
        H = 3
    elif bad == "head_dim":
        hd = 264
    elif bad == "head_dim_multiple":
        hd = 12
    elif bad == "group":
        H, K = 64, 1
    elif bad == "smem":
        H, K, hd, bs = 64, 1, 256, 1024
    q, k, v, lengths = _mk(B, S, H, K, hd)
    q, k, v = _torch(q, k, v)
    lengths = torch.tensor(lengths)
    if bad == "dtype":
        v = v.bfloat16()
    elif bad == "lengths":
        lengths = lengths.long()
    with pytest.raises((ValueError, TypeError)):
        ops.decode_attention(q, k, v, lengths, block_s=bs)


def test_smem_formula_matches_the_source():
    src = decode_attn.source().text
    assert "G * hd + G * bs + 3 * G" in src and "4 * bs * hd" in src
    assert decode_attn.smem_bytes(16, 256, 32, 2) == \
        4 * (16 * 256 + 16 * 32 + 48) + 4 * 32 * 256 * 2
    assert "kMaxHd = 32 * kVec;       // 256" in src
    assert decode_attn.MAX_HEAD_DIM == 256
    assert "kVec = 8;" in src and decode_attn.HEAD_DIM_MULTIPLE == 8
    assert "kMaxG = kMaxGW * kWarps;  // 32" in src
    assert decode_attn.MAX_GROUP == 32


# ---- the split over the sequence (flash-decoding) and its combine ----------
@pytest.mark.parametrize("B,K,S,bs,n_sm,want", [
    (8, 1, 2048, 32, 132, (32, 64)),      # RecurrentGemma decode: 256 blocks
    (1, 1, 2048, 32, 132, (64, 32)),      # one row: chunks of one tile
    (4, 2, 1000, 32, 132, (32, 32)),
    (64, 8, 4096, 32, 132, (1, 4096)),    # enough rows: no split
    (2, 1, 0, 16, 132, (1, 16)),          # an empty cache
])
def test_split_plan(B, K, S, bs, n_sm, want):
    splits, chunk = decode_attn.split_plan(B, K, S, bs, n_sm)
    assert (splits, chunk) == want
    assert chunk % bs == 0 and splits * chunk >= S and (splits - 1) * chunk < max(S, 1)


def test_split_plan_covers_the_card_at_recurrentgemma_width():
    """B·K = 8 (RecurrentGemma's decode batch, one KV head): the split
    pass's grid holds at least one block per SM of an H100."""
    splits, _ = decode_attn.split_plan(8, 1, 2048, 32, 132)
    assert 8 * splits >= 132


def _split_lengths(S, chunk):
    """Lengths 0, 1, S and one past a split boundary."""
    return np.array([0, 1, S, chunk + 1], np.int32)


@pytest.mark.parametrize("B,S,H,K,hd,bs", [
    (4, 64, 8, 4, 16, 16),
    (4, 100, 4, 1, 32, 8),
    (4, 48, 16, 1, 64, 16),
])
@pytest.mark.parametrize("n_sm", [132, 16])
def test_plain_split_and_combine_match_jax_kernel(B, S, H, K, hd, bs, n_sm):
    """The kernel's two passes, in their plain versions and on the kernel's
    split plan, against the JAX kernel (interpret mode) and the plain whole
    function, with lengths 0, 1, S and one past a split boundary."""
    splits, chunk = decode_attn.split_plan(B, K, S, bs, n_sm)
    assert splits > 1
    q, k, v, _ = _mk(B, S, H, K, hd, seed=5)
    lengths = _split_lengths(S, chunk)
    acc, ml = ref.split_ref(*_torch(q, k, v), torch.tensor(lengths), splits,
                            chunk)
    assert acc.shape == (B, K, splits, H // K, hd) and acc.dtype == torch.float32
    assert ml.shape == (B, K, splits, H // K, 2)
    got = ref.combine_ref(acc, ml, torch.tensor(lengths), S, chunk,
                          torch.float32)
    want = jax_decode_attention(*map(jnp.asarray, (q, k, v, lengths)),
                                block_s=bs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert bool((got[0] == 0).all())                 # length 0: output 0
    whole = ref.decode_attention_ref(*_torch(q, k, v), torch.tensor(lengths))
    torch.testing.assert_close(got[1:], whole[1:], rtol=2e-5, atol=2e-5)


def test_plain_split_and_combine_bf16():
    B, S, H, K, hd, bs = 4, 96, 16, 1, 32, 16
    splits, chunk = decode_attn.split_plan(B, K, S, bs, 132)
    q, k, v, _ = _mk(B, S, H, K, hd, seed=6)
    lengths = _split_lengths(S, chunk)
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
    acc, ml = ref.split_ref(tq, tk, tv, torch.tensor(lengths), splits, chunk)
    got = ref.combine_ref(acc, ml, torch.tensor(lengths), S, chunk,
                          torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = jax_decode_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)),
                                jnp.asarray(lengths), block_s=bs)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_split_partials_hold_each_range():
    """Split i's partial is the online-softmax state of its own positions
    only: recombining the splits by hand gives the whole row, and a split
    past the row's length holds nothing (m = -inf, l = 0)."""
    B, S, H, K, hd = 2, 40, 4, 2, 8
    q, k, v, _ = _mk(B, S, H, K, hd, seed=8)
    q, k, v = _torch(q, k, v)
    lengths = torch.tensor([9, 40], dtype=torch.int32)
    acc, ml = ref.split_ref(q, k, v, lengths, 5, 8)
    assert torch.isinf(ml[0, :, 2:, :, 0]).all() and (ml[0, :, 2:, :, 1] == 0).all()
    # split 1 of row 0 holds position 8 alone: l = 1, acc = v[8]
    assert torch.allclose(ml[0, :, 1, :, 1], torch.ones(K, H // K))
    assert torch.allclose(acc[0, :, 1], v[0, 8][:, None, :].expand(K, H // K, hd))
    # lengths 0 .. S: the plain passes agree with the whole function
    for n in range(1, S + 1):
        ln = torch.tensor([n, S - n + 1], dtype=torch.int32)
        a, m = ref.split_ref(q, k, v, ln, 5, 8)
        torch.testing.assert_close(ref.combine_ref(a, m, ln, S, 8, q.dtype),
                                   ref.decode_attention_ref(q, k, v, ln),
                                   rtol=2e-5, atol=2e-5)


def test_plain_reference_is_the_jax_oracle():
    from repro.kernels.decode_attn.ref import decode_attention_ref as jref
    q, k, v, lengths = _mk(3, 40, 6, 3, 16, seed=7)
    want = jref(*map(jnp.asarray, (q, k, v, lengths)))
    got = ref.decode_attention_ref(*_torch(q, k, v), torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
