"""Plain PyTorch version of K7, flash decode attention (the JAX package's
``kernels/decode_attn/ref.py``)."""
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
