"""Whisper-style encoder-decoder backbone (audio family): the JAX
package's ``models/encdec.py``.

The conv/mel frontend is a stub: the caller gives precomputed frame
embeddings [B, T_enc, D].  Encoder = bidirectional self-attention;
decoder = causal self-attention + cross-attention; GELU MLPs, LayerNorm,
RoPE positions in the self-attentions, as there.

The JAX package stacks each stack's layers and scans them; here
``params["enc_layers"]`` and ``params["dec_layers"]`` hold one dict per
layer, and each layer runs under ``L.remat_wrap(cfg)``.  The decode cache
holds, per decoder layer, the rolling self-attention buffer and the
cross-attention K/V of the encoder output (``build_cache``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import layers as L
from .transformer import _ranks


def _init_enc_layer(gen, cfg, device):
    return {"ln1": L.init_norm(cfg.d_model, cfg, device),
            "attn": L.init_attention(gen, cfg, device),
            "ln2": L.init_norm(cfg.d_model, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def _init_dec_layer(gen, cfg, device):
    return {"ln1": L.init_norm(cfg.d_model, cfg, device),
            "attn": L.init_attention(gen, cfg, device),
            "lnx": L.init_norm(cfg.d_model, cfg, device),
            "xattn": L.init_attention(gen, cfg, device),
            "ln2": L.init_norm(cfg.d_model, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, device):
    """Random parameters drawn from ``gen`` onto ``device`` (on ``meta``:
    shapes only), one dict per encoder and decoder layer."""
    return {
        "embed": L.init_embedding(gen, cfg, device),
        "enc_layers": [_init_enc_layer(gen, cfg, device)
                       for _ in range(cfg.n_enc_layers)],
        "enc_norm": L.init_norm(cfg.d_model, cfg, device),
        "dec_layers": [_init_dec_layer(gen, cfg, device)
                       for _ in range(cfg.n_dec_layers)],
        "final_norm": L.init_norm(cfg.d_model, cfg, device),
    }


def stacked_ndims(cfg: ModelConfig, params):
    """The rank each leaf of ``params`` has in the JAX package's layout,
    where each stack's layers are stacked on a leading axis."""
    return {k: _ranks(v, int(k in ("enc_layers", "dec_layers")))
            for k, v in params.items()}


def _positions(B: int, T: int, device):
    return torch.arange(T, device=device).expand(B, T)


def _enc_layer(lp, x, cfg, pos):
    h, _ = L.attention(lp["attn"], L.norm(lp["ln1"], x, cfg), cfg,
                       mode="bidir", positions=pos)
    x = x + h
    return x + L.mlp(lp["mlp"], L.norm(lp["ln2"], x, cfg), cfg)


def encode(params, frame_embeds, cfg: ModelConfig):
    """frame_embeds: [B, T, D] (stub frontend output) → encoder output
    [B, T, D] in the compute dtype."""
    x = frame_embeds.to(L.cdtype(cfg))
    B, T, _ = x.shape
    pos = _positions(B, T, x.device)
    body = L.remat_wrap(cfg)(_enc_layer)
    for lp in params["enc_layers"]:
        x = body(lp, x, cfg, pos)
    return L.norm(params["enc_norm"], x, cfg)


def _cross_kv(lp, enc_out, cfg):
    dt = enc_out.dtype
    k = torch.einsum("btd,dhk->bthk", enc_out, lp["xattn"]["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", enc_out, lp["xattn"]["wv"].to(dt))
    return k, v


def _dec_layer(lp, x, enc_out, cfg, pos, kv_pos):
    h, _ = L.attention(lp["attn"], L.norm(lp["ln1"], x, cfg), cfg,
                       mode="causal", positions=pos)
    x = x + h
    h, _ = L.attention(lp["xattn"], L.norm(lp["lnx"], x, cfg), cfg,
                       positions=pos, kv=_cross_kv(lp, enc_out, cfg),
                       kv_positions=kv_pos)
    x = x + h
    return x + L.mlp(lp["mlp"], L.norm(lp["ln2"], x, cfg), cfg)


def decode_train(params, enc_out, tokens, cfg: ModelConfig):
    """The decoder over the whole token sequence [B, S] against the
    encoder output → final-normed hidden [B, S, D]."""
    x = L.embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    pos = _positions(B, S, x.device)
    kv_pos = _positions(B, enc_out.shape[1], x.device)
    body = L.remat_wrap(cfg)(_dec_layer)
    for lp in params["dec_layers"]:
        x = body(lp, x, enc_out, cfg, pos, kv_pos)
    return L.norm(params["final_norm"], x, cfg)


def forward(params, batch: Dict, cfg: ModelConfig):
    """batch: {'frame_embeds': [B,T,D], 'tokens': [B,S]} → (hidden, aux
    0.0 in f32)."""
    enc = encode(params, batch["frame_embeds"], cfg)
    hid = decode_train(params, enc, batch["tokens"], cfg)
    return hid, torch.zeros((), dtype=torch.float32, device=hid.device)


# -- decode with cache --------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
               enc_len: int = 1500):
    """Per decoder layer the self-attention buffer ``k``/``v`` ``[batch,
    cache_len, K, hd]`` and the cross-attention ``xk``/``xv`` ``[batch,
    enc_len, K, hd]`` (zero until ``build_cache``), and ``pos``."""
    dt = L.cdtype(cfg)
    hd = cfg.resolved_head_dim

    def z(n):
        return torch.zeros((batch, n, cfg.n_kv_heads, hd), dtype=dt,
                           device=device)
    return {"layers": [{"k": z(cache_len), "v": z(cache_len),
                        "xk": z(enc_len), "xv": z(enc_len)}
                       for _ in range(cfg.n_dec_layers)],
            "pos": 0}


def build_cache(params, enc_out, cfg: ModelConfig, batch: int, cache_len: int):
    """A decode cache with every layer's cross K/V precomputed from the
    encoder output [batch, T, D]."""
    dt = L.cdtype(cfg)
    layers = []
    for lp in params["dec_layers"]:
        xk, xv = _cross_kv(lp, enc_out, cfg)
        shape = (batch, cache_len) + tuple(xk.shape[2:])
        layers.append({"k": torch.zeros(shape, dtype=dt, device=enc_out.device),
                       "v": torch.zeros(shape, dtype=dt, device=enc_out.device),
                       "xk": xk.to(dt), "xv": xv.to(dt)})
    return {"layers": layers, "pos": 0}


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """tokens [B, S] → (logits [B, S, V], cache').  The self-attention
    buffers of ``cache`` are written in place."""
    x = L.embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    pos = int(cache["pos"])
    positions = (pos + torch.arange(S, device=x.device)).expand(B, S)
    layers = []
    for lp, lc in zip(params["dec_layers"], cache["layers"]):
        kv_pos = _positions(B, lc["xk"].shape[1], x.device)
        h, nc = L.attention(lp["attn"], L.norm(lp["ln1"], x, cfg), cfg,
                            mode="causal", positions=positions,
                            cache={"k": lc["k"], "v": lc["v"], "pos": pos})
        x = x + h
        h, _ = L.attention(lp["xattn"], L.norm(lp["lnx"], x, cfg), cfg,
                           positions=positions, kv=(lc["xk"], lc["xv"]),
                           kv_positions=kv_pos)
        x = x + h
        x = x + L.mlp(lp["mlp"], L.norm(lp["ln2"], x, cfg), cfg)
        layers.append({"k": nc["k"], "v": nc["v"], "xk": lc["xk"],
                       "xv": lc["xv"]})
    x = L.norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, {"layers": layers, "pos": pos + S}
