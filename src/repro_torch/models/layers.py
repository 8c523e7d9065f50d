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

* ``constrain`` (``sharding.py``) stands at the JAX package's call sites:
  the identity without an activation mesh; inside a data group of the
  sharded step it makes an activation's layout over the model shards
  explicit (``models/sharded.py``).  Decode attention under a mesh uses
  the grouped forms of ``_sdpa`` (``kv_mode``, ``sharding.kv_cache_mode``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import constrain, kv_cache_mode

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


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or as it is in f64: the precision of the JAX
    package's f32 reductions, softmaxes and gate math, kept in f64 when a
    run computes in f64 (``chip_smoke.py`` holds ill-conditioned
    gradients on the card to the CPU's so)."""
    return x if x.dtype == torch.float64 else x.float()


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype ``wide`` gives a tensor of ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


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
    x32 = wide(x)
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
    x32 = wide(x)
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
    wd = wide_dtype(x.dtype)
    freq = theta ** (-torch.arange(0, half, dtype=wd, device=x.device) / half)
    ang = positions.to(wd)[..., None, None] * freq           # [...,S,1,half]
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


def _sdpa(q, k, v, mask, scale, kv_mode=None):
    """q:[B,Sq,H,D] k,v:[B,Sk,K,D] mask:[B,1,Sq,Sk] → [B,Sq,H,D].  Logits
    cast to f32, masked with -1e30, softmax in f32, probabilities cast to
    ``v.dtype`` before the PV product.

    ``kv_mode=None`` (training) expands KV to H heads (the head dim stays
    intact for tensor parallelism).  Decode under a mesh uses the grouped
    form, q ``[B, Sq, K, H/K, D]`` against the unexpanded cache:
    ``kv_mode='seq'``: the cache's sequence dim is 'model'-split and the
    logits keep it split: the softmax is ``exp(logits - logsumexp)``, each
    shard's logsumexp combined across the shards, and each shard's PV
    product a partial sum, summed once;
    ``kv_mode='heads'``: kv_heads divide the model axis and the grouped
    products split on the K dim."""
    B, Sq, H, D = q.shape
    if kv_mode is None:
        k = _expand_kv(k, H)
        v = _expand_kv(v, H)
        logits = wide(torch.einsum("bqhd,bshd->bhqs", q, k))
        logits = constrain(logits * scale, "batch", "heads")
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)

    K = k.shape[2]
    if kv_mode == "seq":
        q = constrain(q, "batch", "seq", None, "head_dim")
        k = constrain(k, "batch", "kv_seq", None, "head_dim")
        v = constrain(v, "batch", "kv_seq", None, "head_dim")
    qg = q.reshape(B, Sq, K, H // K, D)
    logits = wide(torch.einsum("bqkgd,bskd->bkgqs", qg, k))
    logits = logits * scale
    if kv_mode == "seq":
        logits = constrain(logits, "batch", None, None, None, "kv_seq")
    else:
        logits = constrain(logits, "batch", "kv_heads")
    logits = logits.masked_fill(~mask[:, :, None], -1e30)
    if kv_mode == "seq":
        probs = torch.exp(logits - torch.logsumexp(logits, dim=-1)[..., None])
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    if kv_mode == "seq":
        out = constrain(out, "batch", "seq", None, None, "head_dim")
    return out.reshape(B, Sq, H, D)


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
    m = torch.full((B, H, Sq), -float("inf"), dtype=wide_dtype(q.dtype),
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=wide_dtype(q.dtype), device=q.device)
    for c in range(nch):
        kb, vb = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]
        pb = k_pos[:, c * chunk:(c + 1) * chunk]
        logits = wide(torch.einsum("bqhd,bshd->bhqs", q, kb))
        logits = logits * scale
        logits = constrain(logits, "batch", "heads")
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
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_positions: Optional[torch.Tensor] = None,
              cache: Optional[Dict] = None):
    """Self- or cross-attention (the JAX package's three branches; the
    full sequence blockwise over KV chunks when ``cfg.attn_chunk``).

    ``kv``: precomputed (k, v) ``[B, T, K, D]`` for cross-attention (the
    encoder-decoder's decoder), at ``kv_positions``; bidirectional, no
    RoPE on the query.
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
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    new_cache = None
    if kv is not None:                     # cross-attention
        k, v = kv
        k_pos = kv_positions
        mode, window = "bidir", None
    else:
        q = rope(q, positions, cfg.rope_theta)
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
        if cache is None:
            k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
            v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
        k = rope(k, positions, cfg.rope_theta)
        if cache is not None:              # decode with KV cache
            Sc = cache["k"].shape[1]
            pos = int(cache["pos"])
            # lax.dynamic_update_slice clamps the start so the update fits
            slot = min(pos % Sc, Sc - S)
            cache["k"][:, slot:slot + S] = k.to(cache["k"].dtype)
            cache["v"][:, slot:slot + S] = v.to(cache["v"].dtype)
            k, v = cache["k"], cache["v"]
            if kv_cache_mode(cfg) == "seq":
                # keep the updated cache seq-split
                k = constrain(k, "batch", "kv_seq", None, "head_dim")
                v = constrain(v, "batch", "kv_seq", None, "head_dim")
            k_pos = cache_abs_pos(pos, Sc, x.device).expand(B, Sc)
            new_cache = {"k": k, "v": v, "pos": pos + S}
        else:                              # full-sequence self-attention
            k_pos = positions

    if cfg.attn_chunk and cache is None:
        out = _sdpa_chunked(q, k.to(dt), v.to(dt), positions, k_pos, mode,
                            window, scale, cfg.attn_chunk)
    else:
        msk = _mask(positions, k_pos, mode, window)[:, None]
        out = _sdpa(q, k.to(dt), v.to(dt), msk, scale,
                    kv_mode=kv_cache_mode(cfg) if cache is not None else None)
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return constrain(out, "batch", "seq", "embed"), new_cache


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
        g = constrain(g, "batch", "seq", "ff")
        u = constrain(u, "batch", "seq", "ff")
        act = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt))
        h = constrain(h, "batch", "seq", "ff")
        if cfg.act == "sqrelu":
            r = F.relu(h)
            h = r * r
        else:
            h = F.gelu(h, approximate="tanh")
    out = torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))
    return constrain(out, "batch", "seq", "embed")


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
    return constrain(p["tok"][tokens].to(cdtype(cfg)), "batch", "seq", "embed")


def unembed(p, x, cfg: ModelConfig):
    """Logits in ``x.dtype``.  Tied: ``tok.to(dt).T * d_model**-0.5``, a
    multiply in ``dt`` before the product, as in the JAX package."""
    dt = x.dtype
    if cfg.tie_embeddings:
        w = p["tok"].to(dt).T * (cfg.d_model ** -0.5)
    else:
        w = p["out"].to(dt)
    return constrain(torch.einsum("bsd,dv->bsv", x, w), "batch", "seq", "vocab")
