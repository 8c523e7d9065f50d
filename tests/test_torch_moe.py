"""Port parity: the MoE FFN (``models/moe.py``) against the JAX package's,
on the JAX package's tiny Mixtral expert weights carried across by
``interop.params_from_jax``, with inputs made with numpy from a seed.

The routing comes first: the experts chosen (``gate_idx``), the slots
kept within capacity and each kept slot's buffer position must equal the
JAX package's (computed from its own lines, ``repro/models/moe.py``
:61-83: top-k of the f32 softmax, the cumsum over the ``[n, G·K, E]``
one-hot, token-major then k), before any value is compared.  On a near
tie between two experts the comparison fails and says so.  Then the
output and the aux loss, with capacity factor 0.75 (slots dropped), the
published 1.25, the tiny config's 4 (none dropped), dropless, and over
several groups; and the gradient of every input with slots dropped.

Tolerances: f32 1e-5 of the largest magnitude compared, the gradients
too; bf16 0.05 × max(1, |ref|).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402

F32_TOL = 1e-5
BF16_REL = 0.05
TIE = 1e-6


def _cfgs(dtype="float32", **moe_kw):
    j = jconfigs.tiny(jconfigs.get("mixtral-8x7b"))
    t = configs.tiny(configs.get("mixtral-8x7b"))
    j = dataclasses.replace(j, dtype=dtype,
                            moe=dataclasses.replace(j.moe, **moe_kw))
    t = dataclasses.replace(t, dtype=dtype,
                            moe=dataclasses.replace(t.moe, **moe_kw))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _weights(cfg, seed=0):
    """The JAX package's ``init_moe`` draw, in both layouts."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), cfg)
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_routing(jp, x, cfg, dropless=False):
    """The JAX package's routing of ``x`` [B, S, D]: its lines, in order."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    T = B * S
    G = max(1, min(m.group_size, T))
    xg = jnp.asarray(x).reshape(T // G, G, D)
    logits = jnp.einsum("ngd,de->nge", xg, jp["router"].astype(xg.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    C = G * K if dropless else int(m.capacity_factor * G * K / E + 0.5)
    C = max(C, 1)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(T // G, G * K, E), axis=1) - 1.0
    pos = pos.reshape(T // G, G, K, E)
    within = (pos < C) & (onehot > 0)
    slot_pos = jnp.where(within, pos, 0.0).sum(-1).astype(jnp.int32)
    return (np.asarray(probs), np.asarray(gate_vals), np.asarray(gate_idx),
            np.asarray(slot_pos), np.asarray(within.any(-1)), C)


def _assert_same_routing(got, want, probs):
    gate_vals, gate_idx, pos, kept, C, _ = got
    w_vals, w_idx, w_pos, w_kept, w_C = want
    # a near tie between the k-th and the (k+1)-th expert makes the choice
    # depend on the last bit: say so rather than compare
    top = np.sort(probs, axis=-1)[..., ::-1]
    gaps = np.abs(np.diff(top[..., :gate_idx.shape[-1] + 1], axis=-1))
    assert gaps.min() > TIE, f"near tie in the routing: gap {gaps.min()}"
    assert C == w_C
    np.testing.assert_array_equal(gate_idx.numpy(), w_idx)
    np.testing.assert_array_equal(kept.numpy(), w_kept)
    np.testing.assert_array_equal(np.where(w_kept, pos.numpy(), 0), w_pos)
    np.testing.assert_allclose(gate_vals.numpy(), w_vals, rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("capacity,dropless,shape,group", [
    (0.75, False, (2, 24, 64), 64),      # slots dropped
    (1.25, False, (2, 24, 64), 64),      # the published capacity factor
    (4.0, False, (2, 24, 64), 64),       # the tiny config: none dropped
    (1.25, True, (3, 1, 64), 64),        # decode: dropless
    (1.0, False, (4, 16, 64), 16),       # four groups
])
def test_routing_and_output_match_jax(capacity, dropless, shape, group):
    jcfg, cfg = _cfgs(capacity_factor=capacity, group_size=group)
    jp, p = _weights(jcfg)
    x = _x(shape)
    want = _jax_routing(jp, x, jcfg, dropless)
    T = shape[0] * shape[1]
    G = min(group, T)
    got = moe.route(p, torch.tensor(x).reshape(T // G, G, shape[2]), cfg,
                    dropless)
    _assert_same_routing(got, want[1:], want[0])
    if capacity <= 1.0:
        assert (~got[3]).any()                 # some slots were dropped
    wout, waux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, dropless=dropless)
    out, aux = moe.moe_ffn(p, torch.tensor(x), cfg, dropless=dropless)
    assert out.shape == shape and out.dtype == torch.float32
    scale = max(1.0, float(np.abs(np.asarray(wout)).max()))
    assert float(np.abs(out.numpy() - np.asarray(wout)).max()) <= F32_TOL * scale
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(waux), rtol=F32_TOL)


def test_dropped_slots_are_the_later_ones():
    """A slot is dropped when its expert's running count reaches C: the
    kept slots of an expert are its first C in token-major, k order."""
    _, cfg = _cfgs(capacity_factor=0.5, group_size=48)
    _, p = _weights(cfg, seed=2)
    xg = torch.tensor(_x((1, 48, 64), seed=3))
    _, idx, pos, kept, C, _ = moe.route(p, xg, cfg)
    assert C == int(0.5 * 48 * 2 / 4 + 0.5)
    for e in range(cfg.moe.n_experts):
        order = pos[idx == e]
        assert torch.equal(order, torch.arange(len(order)))
        assert torch.equal(kept[idx == e], order < C)


def test_bf16_matches_jax():
    jcfg, cfg = _cfgs("bfloat16", capacity_factor=1.25)
    jp, p = _weights(jcfg, seed=4)
    x = _x((2, 16, 64), seed=5)
    wout, waux = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    out, aux = moe.moe_ffn(p, torch.tensor(x).to(torch.bfloat16), cfg)
    assert out.dtype == torch.bfloat16
    w = np.asarray(wout, np.float32)
    assert np.abs(out.float().numpy() - w).max() <= BF16_REL * max(1.0, np.abs(w).max())
    assert abs(float(aux) - float(waux)) <= BF16_REL * abs(float(waux))


def test_gradients_match_jax():
    """d(sum(out · r) + aux)/d(x, router, wg, wu, wo), slots dropped."""
    jcfg, cfg = _cfgs(capacity_factor=0.75)
    jp, p = _weights(jcfg, seed=6)
    x = _x((2, 24, 64), seed=7)
    r = _x((2, 24, 64), seed=8)

    def jloss(jp, x):
        out, aux = jmoe.moe_ffn(jp, x, jcfg)
        return jnp.sum(out * r) + aux
    wg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_ffn(leaves, xt, cfg)
    (out * torch.tensor(r)).sum().add(aux).backward()
    for name, got, want in [("x", xt.grad, wg[1])] + [
            (k, leaves[k].grad, wg[0][k]) for k in p]:
        w = np.asarray(want)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got.numpy() - w).max()) <= F32_TOL * scale, name


def test_init_moe_shapes_and_active_count():
    _, cfg = _cfgs()
    jp, _ = _weights(cfg)
    mine = moe.init_moe(None, cfg, "meta")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    full = configs.get("mixtral-8x7b")
    # experts count at top_k / E
    assert api.active_param_count(full) == 12_879_925_248
    loaded = interop.params_from_jax(
        {"embed": {}, "layers": {"moe": {k: np.stack([np.asarray(v)] * 2)
                                         for k, v in jp.items()}},
         "final_norm": {}}, cfg, device="cpu")
    assert len(loaded["layers"]) == 2
    assert torch.equal(loaded["layers"][1]["moe"]["wo"],
                       torch.tensor(np.asarray(jp["wo"])))
