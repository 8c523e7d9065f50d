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

Under a mesh (the sharded step, ``models/sharded.py``) each data group
routes its own rows: the routing groups are those of the microbatch's
global token count, which must not straddle two data groups unless no
slot is dropped; the load-balancing loss is the microbatch's, not a
group's (``AuxStats``).  ``constrain`` stands at the JAX package's call
sites: the experts' products split ``d_ff`` over the model shards, and
``wo``'s partial sums are summed once, in f32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import active_group, constrain

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


class AuxStats:
    """The routing statistic ``ce`` (each expert's share of first choices)
    of one microbatch run as data groups one after another.  The JAX
    package's load-balancing loss ``w·E·Σ_e me_e·ce_e`` takes both means
    over every token of the microbatch; ``ce`` comes from a top-k index and
    carries no gradient, so with ``ce`` fixed to the microbatch's mean the
    loss is linear in each group's ``me``, and the groups' losses, weighted
    by their shares, sum to the microbatch's in value and gradient.

    ``collect(gi)``: a forward pass of group ``gi`` records each MoE
    layer's ``ce``; ``fixed(gi)``: group ``gi``'s pass uses the mean over
    the groups instead, after checking that it routed exactly as it did
    when collected (a layer recomputed in the backward pass checks
    again)."""

    def __init__(self):
        self.ce: Dict[int, List[torch.Tensor]] = {}
        self.mean: Dict[int, torch.Tensor] = {}
        self.group: Optional[int] = None
        self.mode: Optional[str] = None

    @contextlib.contextmanager
    def _use(self, mode: str, gi: int):
        global _STATS
        prev, _STATS = _STATS, self
        self.mode, self.group = mode, gi
        try:
            yield self
        finally:
            _STATS, self.mode, self.group = prev, None, None

    def collect(self, gi: int):
        return self._use("collect", gi)

    def fixed(self, gi: int):
        if not self.mean:
            self.mean = {k: torch.stack([c.to(v[0].device) for c in v]).mean(0)
                         for k, v in self.ce.items()}
        return self._use("fixed", gi)

    def take(self, key: int, ce):
        """``ce`` of the layer ``key`` in the running group: recorded, or
        checked and replaced by the mean."""
        here = ce.parts[0] if hasattr(ce, "parts") else ce
        if self.mode == "collect":
            self.ce.setdefault(key, []).append(here.detach().clone())
            return ce
        seen = self.ce[key][self.group]
        # meta tensors (a step accounted on meta shards) hold no values
        if seen.device.type != "meta" and not torch.equal(here.to(seen.device), seen):
            raise RuntimeError(f"MoE routing of data group {self.group} differs "
                               f"from its statistics pass")
        return self.mean[key]


_STATS: Optional[AuxStats] = None


def _layer_key(p) -> int:
    r = p["router"]
    return id(getattr(r, "leaf", r))


def _capacity(m, G: int, dropless: bool) -> int:
    """An expert's buffer slots for a routing group of ``G`` tokens."""
    if dropless:
        return G * m.top_k
    return max(int(m.capacity_factor * G * m.top_k / m.n_experts + 0.5), 1)


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
    if _STATS is not None:
        ce = _STATS.take(_layer_key(p), ce)
    aux = m.aux_loss_weight * E * torch.sum(me * ce)

    C = _capacity(m, G, dropless)
    # position of each (token, k) inside its expert buffer: a running count
    # over the group's slots, token-major then k
    onehot = F.one_hot(gate_idx, E).reshape(n, G * K, E)
    pos = (torch.cumsum(onehot, dim=1) - 1).reshape(n, G, K, E)
    pos = torch.gather(pos, -1, gate_idx[..., None])[..., 0]
    return gate_vals, gate_idx, pos, pos < C, C, aux


def moe_ffn(p, x, cfg: ModelConfig,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] → (out [B, S, D], aux_loss scalar f32).  The group
    size must divide B·S (the configs pick it so).  Inside a data group
    of the sharded step, B is the group's rows and the routing groups are
    those of the microbatch's ``n_data · B · S`` tokens."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    dt = x.dtype
    T = B * S
    g = active_group()
    T_all = T * (g.n_data if g is not None else 1)
    G = max(1, min(m.group_size, T_all))
    if T % G:
        # a routing group would straddle data groups: the same result only
        # where no slot is dropped, whatever the grouping
        C = _capacity(m, G, dropless)
        if C < G * K:
            raise ValueError(
                f"{cfg.name}: routing groups of {G} tokens straddle data groups "
                f"of {T} tokens, and capacity {C} < {G * K} drops tokens")
        G, dropless = T, True
    n = T // G
    xg = constrain(x.reshape(n, G, D), "batch", None, None)
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
    expert_in = constrain(expert_in, "experts", "batch", None)

    gh = torch.einsum("ecd,edf->ecf", expert_in, p["wg"].to(dt))
    u = torch.einsum("ecd,edf->ecf", expert_in, p["wu"].to(dt))
    gh = constrain(gh, "experts", "batch", "ff")
    u = constrain(u, "experts", "batch", "ff")
    h = F.silu(gh) * u
    expert_out = torch.einsum("ecf,efd->ecd", h, p["wo"].to(dt))
    expert_out = constrain(expert_out, "experts", "batch", None)

    # combine: each slot's expert output times its gate value (0 where
    # dropped; cast to the compute dtype, as the JAX package's combine
    # weights), summed over the token's slots in f32 and rounded once
    w = wide((gate_vals * kept).to(dt)).reshape(-1)
    expert_out = torch.cat([expert_out.reshape(rows, D),
                            expert_out.new_zeros((1, D))])
    out = torch.zeros((T, D), dtype=wide_dtype(dt), device=x.device)
    out = out.index_add(0, token, wide(expert_out[slot]) * w[:, None]).to(dt)
    return out.reshape(B, S, D), aux
