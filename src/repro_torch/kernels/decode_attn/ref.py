"""Plain PyTorch versions of K7, flash decode attention: the whole function
(the JAX package's ``kernels/decode_attn/ref.py``), and the kernel's two
passes, split over the sequence and combined."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, lengths):
    """q: [B,H,hd]; k,v: [B,S,K,hd]; lengths: [B] valid KV entries.
    GQA grouping: q head h reads kv head h // (H//K).  → [B,H,hd] in
    ``q.dtype``; logits, softmax and the weighted sum in f32."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k.float()) * (hd ** -0.5)
    mask = torch.arange(S, device=q.device)[None] < lengths[:, None].to(q.device)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def split_ref(q, k, v, lengths, splits: int, chunk: int):
    """The split pass: for split ``i`` of each (batch row, KV head), the
    online-softmax state of positions ``[i·chunk, min((i+1)·chunk,
    length))``: ``acc [B, K, splits, G, hd]`` (Σ e^{logit - m} v) and
    ``ml [B, K, splits, G, 2]`` (m = the largest logit, l = Σ e^{logit -
    m}), all f32.  A split that starts at or past the row's length holds
    m = -inf, l = 0, acc = 0 (the kernel writes nothing there)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    pos = torch.arange(splits * chunk, device=q.device)
    kp = torch.zeros((B, splits * chunk, K, hd), dtype=torch.float32,
                     device=q.device)
    vp = torch.zeros_like(kp)
    n = min(S, splits * chunk)
    kp[:, :n], vp[:, :n] = k[:, :n].float(), v[:, :n].float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, kp) * (hd ** -0.5)
    valid = pos[None] < lengths.clamp(0, S)[:, None].to(q.device)   # [B, P]
    logits = logits.masked_fill(~valid[:, None, None], float("-inf"))
    logits = logits.reshape(B, K, G, splits, chunk)
    m = logits.amax(-1)                                   # [B, K, G, splits]
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgic,bickd->bkgid", p,
                       vp.reshape(B, splits, chunk, K, hd))
    return (acc.permute(0, 1, 3, 2, 4).contiguous(),
            torch.stack([m, l], -1).permute(0, 1, 3, 2, 4).contiguous())


def combine_ref(acc, ml, lengths, S: int, chunk: int, dtype):
    """The combine pass: over the splits ``i < ceil(length / chunk)`` of
    each (batch row, KV head, query row), ``m = max m_i``, ``l = Σ l_i
    e^{m_i - m}``, ``o = Σ acc_i e^{m_i - m} / l`` (0 where no split has a
    partial) → ``[B, K·G, hd]`` of ``dtype``."""
    B, K, splits, G, hd = acc.shape
    n = (lengths.clamp(0, S).to(acc.device) + chunk - 1) // chunk
    used = torch.arange(splits, device=acc.device)[None] < n[:, None]  # [B, splits]
    m_i = ml[..., 0].masked_fill(~used[:, None, :, None], float("-inf"))
    m = m_i.amax(2, keepdim=True)
    w = torch.where(torch.isfinite(m_i),
                    torch.exp(m_i - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
    l = (ml[..., 1].masked_fill(~used[:, None, :, None], 0.0) * w).sum(2)
    o = (acc.masked_fill(~used[:, None, :, None, None], 0.0)
         * w[..., None]).sum(2) / l.clamp_min(1e-30)[..., None]
    return o.reshape(B, K * G, hd).to(dtype)
