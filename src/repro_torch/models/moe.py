"""Mixture-of-Experts FFN (Mixtral-style top-k routing, GShard capacity
dispatch): the JAX package's ``models/moe.py``.

Tokens are grouped (``moe.group_size``) and each (token, k) routing slot
gets a position in its expert's buffer from a cumsum over the one-hot
routing, token-major then k, as there; slots at or past the capacity
``C`` are dropped (capacity_factor 1.25, as GShard).  Where the JAX
package dispatches and combines with one-hot einsums, the port scatters
the kept slots' rows into the ``[E, n_groups, C, D]`` buffers
(``index_add`` on distinct rows; dropped slots into a spare row) and
gathers them back, weighting each by its gate value (0 where dropped):
the same kept set, positions and combine weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import dense_init, pdtype, wide, wide_dtype


def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig, device):
    """Router ``[d, E]`` and the experts' SwiGLU weights ``wg``/``wu``
    ``[E, d, f]``, ``wo`` ``[E, f, d]``."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.n_experts
    dt = pdtype(cfg)
    return {
        "router": dense_init(gen, (d, E), dt, device),
        "wg": dense_init(gen, (E, d, f), dt, device),
        "wu": dense_init(gen, (E, d, f), dt, device),
        "wo": dense_init(gen, (E, f, d), dt, device, scale=f ** -0.5),
    }


def route(p, xg, cfg: ModelConfig, dropless: bool = False):
    """Routing of the grouped tokens ``xg`` ``[n, G, D]``: → (gate values
    ``[n, G, K]`` f32 renormalized over the top k, expert indices
    ``[n, G, K]``, each slot's position in its expert's buffer ``[n, G,
    K]``, kept ``[n, G, K]`` bool, capacity ``C``, aux loss f32).

    ``dropless=True`` sets C = G·K (no slot is ever dropped) — the decode
    path's setting, so that single-token routing matches training routing
    whatever the grouping."""
    m = cfg.moe
    n, G, _ = xg.shape
    E, K = m.n_experts, m.top_k
    logits = torch.einsum("ngd,de->nge", xg, p["router"].to(xg.dtype))
    probs = torch.softmax(wide(logits), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)     # [n, G, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # load-balancing auxiliary loss (Switch/GShard form)
    me = probs.mean(dim=(0, 1))                             # [E]
    ce = F.one_hot(gate_idx[..., 0], E).to(probs.dtype).mean(dim=(0, 1))
    aux = m.aux_loss_weight * E * torch.sum(me * ce)

    C = G * K if dropless else int(m.capacity_factor * G * K / E + 0.5)
    C = max(C, 1)
    # position of each (token, k) inside its expert buffer: a running count
    # over the group's slots, token-major then k
    onehot = F.one_hot(gate_idx, E).reshape(n, G * K, E)
    pos = (torch.cumsum(onehot, dim=1) - 1).reshape(n, G, K, E)
    pos = torch.gather(pos, -1, gate_idx[..., None])[..., 0]
    return gate_vals, gate_idx, pos, pos < C, C, aux


def moe_ffn(p, x, cfg: ModelConfig,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] → (out [B, S, D], aux_loss scalar f32).  The group
    size must divide B·S (the configs pick it so)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    dt = x.dtype
    T = B * S
    G = max(1, min(m.group_size, T))
    n = T // G
    xg = x.reshape(n, G, D)
    gate_vals, gate_idx, pos, kept, C, aux = route(p, xg, cfg, dropless)

    # every slot's token row and its row in the [E, n, C] buffers; a dropped
    # slot goes to a spare row past the end (no host sync on a kept mask)
    group = torch.arange(n, device=x.device)[:, None, None]
    token = (group * G + torch.arange(G, device=x.device)[None, :, None]
             ).expand(n, G, K).reshape(-1)
    rows = E * n * C
    slot = torch.where(kept, (gate_idx * n + group) * C + pos, rows).reshape(-1)
    flat = x.reshape(T, D)
    expert_in = flat.new_zeros((rows + 1, D)).index_add(0, slot, flat[token])
    expert_in = expert_in[:rows].reshape(E, n * C, D)

    g = torch.einsum("ecd,edf->ecf", expert_in, p["wg"].to(dt))
    u = torch.einsum("ecd,edf->ecf", expert_in, p["wu"].to(dt))
    h = F.silu(g) * u
    expert_out = torch.einsum("ecf,efd->ecd", h, p["wo"].to(dt))

    # combine: each slot's expert output times its gate value (0 where
    # dropped; cast to the compute dtype, as the JAX package's combine
    # weights), summed over the token's slots in f32 and rounded once
    w = wide((gate_vals * kept).to(dt)).reshape(-1)
    expert_out = torch.cat([expert_out.reshape(rows, D),
                            expert_out.new_zeros((1, D))])
    out = torch.zeros((T, D), dtype=wide_dtype(dt), device=x.device)
    out = out.index_add(0, token, wide(expert_out[slot]) * w[:, None]).to(dt)
    return out.reshape(B, S, D), aux
