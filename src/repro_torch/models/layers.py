"""Shared LM layers, functional style (params are plain dicts of tensors):
the JAX package's ``models/layers.py``.

Conventions, as there:

* Activations run in ``cfg.dtype`` (bf16); params are stored in
  ``cfg.param_dtype`` (f32 master) and cast at use.
* Attention supports GQA/MQA, causal/bidirectional/sliding-window masks,
  blockwise-KV online softmax (``cfg.attn_chunk``) and KV-cache decode
  (full cache or rolling window buffer).  The cache is updated in place
  (the JAX package returns a new one).
* ``remat_wrap`` is ``torch.utils.checkpoint`` (non-reentrant) where the
  JAX package uses ``jax.checkpoint``.
* Every ``init_*`` draws from an explicit ``torch.Generator`` onto an
  explicit device; on the ``meta`` device it draws nothing (shapes only).

Not ported yet: the sharding constraints (``constrain``, ``kv_cache_mode``:
the identity and ``None`` without a mesh; ROADMAP.md queue 1, item 9) and
cross-attention (the encoder-decoder family, item 11).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig

# the matmul operators a "dots" policy keeps (einsum lowers to these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(cfg: ModelConfig):
    """Layer-body remat transform per cfg: 'full' recomputes everything in
    the backward pass; 'dots' saves the matmul outputs and recomputes the
    rest.  Both are non-reentrant ``torch.utils.checkpoint``."""
    if not cfg.remat:
        return lambda f: f
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)
    return lambda f: functools.partial(_ckpt.checkpoint, f, **kw)


def cdtype(cfg: ModelConfig) -> torch.dtype:
    """Compute dtype of the activations."""
    return getattr(torch, cfg.dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    """Storage dtype of the parameters."""
    return getattr(torch, cfg.param_dtype)


def dense_init(gen: Optional[torch.Generator], shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default
    ``fan_in ** -0.5``, fan-in the first axis)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.device.type != "meta":
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(s)
    return w.to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def init_rmsnorm(d, cfg, device):
    """RMSNorm scale, ones."""
    return {"scale": torch.ones((d,), dtype=pdtype(cfg), device=device)}


def rmsnorm(p, x, eps=1e-6):
    """Variance in f32; ``rsqrt`` cast to the input dtype, then
    ``x * inv * scale`` in the input dtype (the JAX package's order)."""
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv * p["scale"].to(dt)


def init_layernorm(d, cfg, device):
    """LayerNorm scale (ones) and bias (zeros)."""
    return {"scale": torch.ones((d,), dtype=pdtype(cfg), device=device),
            "bias": torch.zeros((d,), dtype=pdtype(cfg), device=device)}


def layernorm(p, x, eps=1e-5):
    """Mean and variance in f32, the rest in the input dtype."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    out = (x - mu.to(dt)) * inv
    return out * p["scale"].to(dt) + p["bias"].to(dt)


def init_norm(d, cfg, device):
    """The norm ``cfg.norm`` names."""
    return (init_rmsnorm(d, cfg, device) if cfg.norm == "rmsnorm"
            else init_layernorm(d, cfg, device))


def norm(p, x, cfg):
    """Apply the norm ``cfg.norm`` names."""
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] int.  Rotates the two
    concatenated halves (not interleaved pairs), angles in f32."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None, None] * freq          # [...,S,1,half]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def init_attention(gen, cfg: ModelConfig, device, d_model: Optional[int] = None):
    """Projections wq ``[d, H, hd]``, wk/wv ``[d, K, hd]``, wo ``[H, hd, d]``."""
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    dt = pdtype(cfg)
    return {
        "wq": dense_init(gen, (d, cfg.n_heads, hd), dt, device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads, hd), dt, device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads, hd), dt, device),
        "wo": dense_init(gen, (cfg.n_heads, hd, d), dt, device,
                         scale=(cfg.n_heads * hd) ** -0.5),
    }


def _mask(q_pos, k_pos, mode: str, window: Optional[int]):
    """[..., Sq, Sk] boolean mask. q_pos/k_pos: [..., S] int."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    if mode == "bidir":
        m = kp >= 0
    else:
        # kp >= 0 also masks never-written cache slots
        m = (kp <= qp) & (kp >= 0)
    if window is not None:
        m = m & (kp > qp - window)
    return m


def _expand_kv(k, H: int):
    """GQA: repeat KV heads to H query heads (q heads [g·G, g·G+G) map to
    kv head g)."""
    K = k.shape[2]
    if K == H:
        return k
    return torch.repeat_interleave(k, H // K, dim=2)


def _sdpa(q, k, v, mask, scale):
    """q:[B,Sq,H,D] k,v:[B,Sk,K,D] mask:[B,1,Sq,Sk] → [B,Sq,H,D].  KV
    expanded to H heads; logits cast to f32, masked with -1e30, softmax in
    f32, probabilities cast to ``v.dtype`` before the PV product (the JAX
    package's ``kv_mode=None`` branch)."""
    H = q.shape[2]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).float()
    logits = logits * scale
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)


def _sdpa_chunked(q, k, v, q_pos, k_pos, mode, window, scale, chunk):
    """Blockwise-KV online-softmax attention: a loop over KV chunks, peak
    memory O(Sq·chunk) instead of O(Sq·Sk).  Logits, running max and sum
    in f32; the accumulator in ``v.dtype``; padded keys (a ragged last
    chunk) sit at position -1e9, masked with -1e30 as the rest."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    nch = -(-Sk // chunk)
    pad = nch * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-(10 ** 9))
    acc = torch.zeros((B, H, Sq, D), dtype=v.dtype, device=q.device)
    m = torch.full((B, H, Sq), -float("inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for c in range(nch):
        kb, vb = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]
        pb = k_pos[:, c * chunk:(c + 1) * chunk]
        logits = torch.einsum("bqhd,bshd->bhqs", q, kb).float()
        logits = logits * scale
        msk = _mask(q_pos, pb, mode, window)             # [B, Sq, chunk]
        logits = logits.masked_fill(~msk[:, None], -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqs,bshd->bhqd", p.to(vb.dtype), vb)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.transpose(1, 2)


def cache_abs_pos(pos: int, Sc: int, device) -> torch.Tensor:
    """Absolute position held by each slot of a rolling buffer of ``Sc``
    slots when the next token goes to position ``pos`` (only valid where
    ≤ ``pos``; never-written slots come out negative)."""
    idx = torch.arange(Sc, dtype=torch.int64, device=device)
    return pos - ((pos % Sc) - idx) % Sc


def attention(p, x, cfg: ModelConfig, *,
              mode: str = "causal",
              window: Optional[int] = None,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[Dict] = None):
    """Self-attention (the JAX package's cache and full-sequence branches;
    the full sequence blockwise over KV chunks when ``cfg.attn_chunk``).

    ``cache``: {'k','v' [B,Sc,K,D], 'pos' int} decode-time KV cache — writes
    the new tokens at slot ``pos % Sc`` (rolling buffer) in place.
    Returns (out, new_cache)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    scale = hd ** -0.5
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q = rope(q, positions, cfg.rope_theta)
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:                  # decode with KV cache
        Sc = cache["k"].shape[1]
        pos = int(cache["pos"])
        # lax.dynamic_update_slice clamps the start so the update fits
        slot = min(pos % Sc, Sc - S)
        cache["k"][:, slot:slot + S] = k.to(cache["k"].dtype)
        cache["v"][:, slot:slot + S] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        k_pos = cache_abs_pos(pos, Sc, x.device).expand(B, Sc)
        new_cache = {"k": k, "v": v, "pos": pos + S}
    else:                                  # full-sequence self-attention
        k_pos = positions

    if cfg.attn_chunk and cache is None:
        out = _sdpa_chunked(q, k.to(dt), v.to(dt), positions, k_pos, mode,
                            window, scale, cfg.attn_chunk)
    else:
        msk = _mask(positions, k_pos, mode, window)[:, None]
        out = _sdpa(q, k.to(dt), v.to(dt), msk, scale)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out, new_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def init_mlp(gen, cfg: ModelConfig, device, d_model: Optional[int] = None):
    """Gated (swiglu/geglu: wg, wu, wo) or plain (wi, wo) MLP weights."""
    d = d_model or cfg.d_model
    dt = pdtype(cfg)
    if cfg.act in ("swiglu", "geglu"):
        return {"wg": dense_init(gen, (d, cfg.d_ff), dt, device),
                "wu": dense_init(gen, (d, cfg.d_ff), dt, device),
                "wo": dense_init(gen, (cfg.d_ff, d), dt, device,
                                 scale=cfg.d_ff ** -0.5)}
    return {"wi": dense_init(gen, (d, cfg.d_ff), dt, device),
            "wo": dense_init(gen, (cfg.d_ff, d), dt, device,
                             scale=cfg.d_ff ** -0.5)}


def mlp(p, x, cfg: ModelConfig):
    """The MLP ``cfg.act`` names; GELU is the tanh form (``jax.nn.gelu``'s
    default)."""
    dt = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, p["wu"].to(dt))
        act = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt))
        if cfg.act == "sqrelu":
            r = F.relu(h)
            h = r * r
        else:
            h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------
def init_embedding(gen, cfg: ModelConfig, device):
    """Token table ``[vocab, d]`` at unit scale, and an output matrix unless
    the embeddings are tied."""
    dt = pdtype(cfg)
    p = {"tok": dense_init(gen, (cfg.vocab, cfg.d_model), dt, device,
                           scale=1.0)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt, device)
    return p


def embed(p, tokens, cfg: ModelConfig):
    """Rows of the token table, in the compute dtype (gathered, then cast:
    the same values as the JAX package's cast-then-gather)."""
    return p["tok"][tokens].to(cdtype(cfg))


def unembed(p, x, cfg: ModelConfig):
    """Logits in ``x.dtype``.  Tied: ``tok.to(dt).T * d_model**-0.5``, a
    multiply in ``dt`` before the product, as in the JAX package."""
    dt = x.dtype
    if cfg.tie_embeddings:
        w = p["tok"].to(dt).T * (cfg.d_model ** -0.5)
    else:
        w = p["out"].to(dt)
    return torch.einsum("bsd,dv->bsv", x, w)
