"""Decoder-only transformer LM (dense / MoE / SWA / VLM-prefix variants):
the JAX package's ``models/transformer.py``.

The JAX package stacks the layers' parameters along a leading axis and
scans them; here ``params["layers"]`` holds one dict per layer
(``interop.params_from_jax`` unstacks a JAX tree), and ``forward`` and the
decode step are Python loops over them (``forward`` runs each layer under
``L.remat_wrap(cfg)``, as the JAX package's scanned body).  GQA attention
with an optional sliding window, a dense or MoE FFN, and a decode path
over a rolling-buffer KV cache, one ``{"k", "v"}`` per layer.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import layers as L
from .moe import init_moe, moe_ffn


def init_layer(gen, cfg: ModelConfig, device):
    """One layer's parameters: two norms, attention, MLP or MoE FFN."""
    p = {"ln1": L.init_norm(cfg.d_model, cfg, device),
         "attn": L.init_attention(gen, cfg, device),
         "ln2": L.init_norm(cfg.d_model, cfg, device)}
    if cfg.moe:
        p["moe"] = init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, device)
    return p


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, device):
    """Random parameters drawn from ``gen`` onto ``device`` (on ``meta``:
    shapes only), one dict per layer."""
    return {"embed": L.init_embedding(gen, cfg, device),
            "layers": [init_layer(gen, cfg, device)
                       for _ in range(cfg.n_layers)],
            "final_norm": L.init_norm(cfg.d_model, cfg, device)}


def _ranks(tree, extra):
    if isinstance(tree, dict):
        return {k: _ranks(v, extra) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_ranks(v, extra) for v in tree]
    return tree.dim() + extra


def stacked_ndims(cfg: ModelConfig, params):
    """The rank each leaf of ``params`` has in the JAX package's layout,
    where every layer's leaves are stacked on a leading axis (one more
    than here); the optimizer decays a leaf by that rank."""
    return {"embed": _ranks(params["embed"], 0),
            "layers": _ranks(params["layers"], 1),
            "final_norm": _ranks(params["final_norm"], 0)}


def _ffn(lp, x, cfg: ModelConfig, dropless: bool = False):
    hin = L.norm(lp["ln2"], x, cfg)
    if cfg.moe:
        return moe_ffn(lp["moe"], hin, cfg, dropless=dropless)
    return L.mlp(lp["mlp"], hin, cfg), None


def _layer_fwd(lp, x, cfg: ModelConfig, positions):
    h, _ = L.attention(lp["attn"], L.norm(lp["ln1"], x, cfg), cfg,
                       mode="causal", window=cfg.window, positions=positions)
    x = x + h
    h, aux = _ffn(lp, x, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux


def forward(params, tokens, cfg: ModelConfig,
            prefix_embeds: Optional[torch.Tensor] = None):
    """tokens: [B, S] int; prefix_embeds: [B, P, D] (VLM patch stub).
    Returns (hidden [B, P + S, D], aux_loss f32)."""
    x = L.embed(params["embed"], tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    body = L.remat_wrap(cfg)(_layer_fwd)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        x, a = body(lp, x, cfg, positions)
        aux = aux + a
    x = L.norm(params["final_norm"], x, cfg)
    return x, aux


# --------------------------------------------------------------------------
# decode path (new tokens against a KV cache)
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    """Rolling-buffer KV cache, ``{"layers": [{"k", "v"}], "pos"}``, each
    buffer ``[batch, cache_len, n_kv_heads, head_dim]`` in the compute
    dtype.  For SWA archs cache_len = window (bounded); for full attention
    the context."""
    dt = L.cdtype(cfg)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"layers": [{"k": torch.zeros(shape, dtype=dt, device=device),
                        "v": torch.zeros(shape, dtype=dt, device=device)}
                       for _ in range(cfg.n_layers)],
            "pos": 0}


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """tokens: [B, S] → (logits [B, S, V], cache').  The buffers of
    ``cache`` are written in place; the MoE FFN runs dropless."""
    x = L.embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    pos = int(cache["pos"])
    positions = (pos + torch.arange(S, device=x.device)).expand(B, S)
    layers = []
    for lp, lc in zip(params["layers"], cache["layers"]):
        h, nc = L.attention(lp["attn"], L.norm(lp["ln1"], x, cfg), cfg,
                            mode="causal", window=cfg.window,
                            positions=positions,
                            cache={"k": lc["k"], "v": lc["v"], "pos": pos})
        x = x + h
        h, _ = _ffn(lp, x, cfg, dropless=True)
        x = x + h
        layers.append({"k": nc["k"], "v": nc["v"]})
    x = L.norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg), {"layers": layers,
                                                 "pos": pos + S}


def prefill(params, tokens, cfg: ModelConfig, cache_len: int):
    """Run the full prompt and build a decode cache: → (logits [B, S, V],
    cache) with the last ``cache_len`` positions' K/V in the slots they
    belong to (slot = pos % cache_len)."""
    x = L.embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    dt = L.cdtype(cfg)
    cache = init_cache(cfg, B, cache_len, x.device)
    take = min(S, cache_len)
    slots = torch.arange(S - take, S, device=x.device) % cache_len
    for lp, lc in zip(params["layers"], cache["layers"]):
        xn = L.norm(lp["ln1"], x, cfg)
        k = torch.einsum("bsd,dhk->bshk", xn, lp["attn"]["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", xn, lp["attn"]["wv"].to(dt))
        k = L.rope(k, positions, cfg.rope_theta)
        lc["k"][:, slots] = k[:, S - take:].to(dt)
        lc["v"][:, slots] = v[:, S - take:].to(dt)
        h, _ = L.attention(lp["attn"], xn, cfg, mode="causal",
                           window=cfg.window, positions=positions)
        x = x + h
        h, _ = _ffn(lp, x, cfg)
        x = x + h
    x = L.norm(params["final_norm"], x, cfg)
    cache["pos"] = S
    return L.unembed(params["embed"], x, cfg), cache
