"""Griffin / RecurrentGemma: RG-LRU recurrent blocks + local attention,
1:2 (the JAX package's ``models/griffin.py``).

Block pattern (rec, rec, attn) applied cyclically over n_layers (38 for the
9B config ⇒ 12 full cycles + a trailing (rec, rec)).  The JAX package
stacks the full cycles' parameters along a leading axis and scans them;
here ``params["blocks"]`` holds one dict per layer, in layer order
(``interop.params_from_jax`` unstacks a JAX tree), and ``forward`` and the
decode loop are Python loops over them (``forward`` checkpoints each full
cycle, as the JAX package's scanned body).  The temporal conv in the
recurrent block is the causal width-4 depthwise conv K6
(``kernels/conv1d``): its CUDA kernel on the card, its plain version on
the CPU; under autograd its gradient runs K6 again
(``ops.CausalConv1dFn``).

Recurrence: r_t = σ(W_a x_t + b_a); i_t = σ(W_x x_t + b_x)
            a_t = exp(c · softplus(Λ) · (−r_t))      (a ∈ (0,1), c = 8)
            h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)
computed with an associative scan over the sequence (``rg_lru_scan``: the
JAX package's ``lax.associative_scan``, its odd/even recursion and order
of combination, O(log S) depth), and as a single fused state update at
decode time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.conv1d import ops as conv1d_ops
from repro_torch.kernels.conv1d import ref as conv1d_ref
from repro_torch.sharding import constrain

from . import layers as L
from .sharded import local

_C = 8.0


def pattern_of(cfg: ModelConfig) -> Tuple[str, ...]:
    """The repeating block pattern."""
    return tuple(cfg.block_pattern or ("rec", "rec", "attn"))


def block_types(cfg: ModelConfig) -> List[str]:
    """Type of every layer, in order."""
    pat = pattern_of(cfg)
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def _cycle_split(cfg: ModelConfig) -> Tuple[int, int]:
    P = len(pattern_of(cfg))
    return cfg.n_layers // P, cfg.n_layers % P


def init_rec_block(gen, cfg: ModelConfig, device):
    """The recurrent mixing block's parameters."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    dt = L.pdtype(cfg)
    return {
        "ln": L.init_norm(d, cfg, device),
        "w_gate": L.dense_init(gen, (d, w), dt, device),
        "w_x": L.dense_init(gen, (d, w), dt, device),
        "conv_w": L.dense_init(gen, (cfg.conv_width, w), dt, device, scale=0.3),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "wa": L.dense_init(gen, (w, w), dt, device),
        "ba": torch.zeros((w,), dtype=dt, device=device),
        "wi": L.dense_init(gen, (w, w), dt, device),
        "bi": torch.zeros((w,), dtype=dt, device=device),
        # softplus(2) ≈ 2.1 → slow decay init
        "lam": torch.full((w,), 2.0, dtype=dt, device=device),
        "w_out": L.dense_init(gen, (w, d), dt, device, scale=w ** -0.5),
    }


def init_attn_block(gen, cfg: ModelConfig, device):
    """The local-attention mixing block's parameters."""
    return {"ln": L.init_norm(cfg.d_model, cfg, device),
            "attn": L.init_attention(gen, cfg, device)}


def init_mlp_block(gen, cfg: ModelConfig, device):
    """The feed-forward block's parameters."""
    return {"ln": L.init_norm(cfg.d_model, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def _init_block(gen, cfg: ModelConfig, t: str, device):
    mix = (init_rec_block(gen, cfg, device) if t == "rec"
           else init_attn_block(gen, cfg, device))
    return {"mix": mix, "ffn": init_mlp_block(gen, cfg, device)}


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, device):
    """Random parameters drawn from ``gen`` onto ``device`` (on ``meta``:
    shapes only), one block dict per layer."""
    return {"embed": L.init_embedding(gen, cfg, device),
            "blocks": [_init_block(gen, cfg, t, device)
                       for t in block_types(cfg)],
            "final_norm": L.init_norm(cfg.d_model, cfg, device)}


def stacked_ndims(cfg: ModelConfig, params):
    """The rank each leaf of ``params`` has in the JAX package's layout,
    where a full cycle's leaves are stacked on a leading axis (one more
    than here) and the tail's and the rest are not; the optimizer decays
    a leaf by that rank."""
    P = len(pattern_of(cfg))
    stacked = _cycle_split(cfg)[0] * P

    def ranks(tree, extra):
        if isinstance(tree, dict):
            return {k: ranks(v, extra) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [ranks(v, extra) for v in tree]
        return tree.dim() + extra
    return {"embed": ranks(params["embed"], 0),
            "blocks": [ranks(b, int(i < stacked))
                       for i, b in enumerate(params["blocks"])],
            "final_norm": ranks(params["final_norm"], 0)}


# -- temporal conv (1-D causal stencil) -------------------------------------
def causal_conv(x, w, b, state: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None):
    """x: [B,S,W]; w: [cw, W] depthwise.  state: [B, cw-1, W] past inputs.
    Returns (y, new_state).

    ``use_kernel``: None runs K6 (``CausalConv1dFn``: the kernel on CUDA
    tensors, its plain version on CPU ones; its gradient is K6 again);
    True the kernel, and raises off the card; False the plain version on
    any device (for checks; autograd differentiates it)."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    wx = w.to(x.dtype).contiguous()
    # the conv is zero-history over the whole of xp; the outputs aligned
    # with x start at index cw-1
    # on a model-split width (the sharded step) K6 runs on each shard's
    # slice of it
    if use_kernel is False:
        y = local(conv1d_ref.causal_conv1d_ref)(xp, wx)
    elif use_kernel and xp.device.type != "cuda":
        raise ValueError(f"causal_conv(use_kernel=True): the kernel runs on "
                         f"a CUDA device, not {xp.device}")
    else:
        y = local(conv1d_ops.CausalConv1dFn.apply)(xp, wx)
    new_state = xp[:, -(cw - 1):] if cw > 1 else None
    return y[:, cw - 1:] + b.to(x.dtype), new_state


# -- RG-LRU ------------------------------------------------------------------
def _rg_lru_gates(p, x):
    """x: [..., W] → (a, gated_x) in f32, with f32 params."""
    x32 = x.float()
    r = torch.sigmoid(x32 @ p["wa"].float() + p["ba"].float())
    i = torch.sigmoid(x32 @ p["wi"].float() + p["bi"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x32)
    return a, gated


def _associative_scan(combine, elems):
    """Inclusive scan of ``combine`` over axis 1 of every tensor in
    ``elems``: the recursion of ``lax.associative_scan`` (combine adjacent
    pairs, scan the half, fill in the even positions), so the same
    elements are combined in the same order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = combine([e[:, 0:-1:2] for e in elems],
                      [e[:, 1::2] for e in elems])
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    out = []
    for a, b in zip(even, odd):            # a[0], b[0], a[1], b[1], ...
        nb = b.shape[1]
        ab = torch.stack([a[:, :nb], b], dim=2).flatten(1, 2)
        out.append(torch.cat([ab, a[:, nb:]], dim=1) if a.shape[1] > nb else ab)
    return out


def rg_lru_scan(p, x):
    """x: [B,S,W] → h: [B,S,W] via an associative scan over time in f32,
    cast to ``x.dtype``."""
    a, gx = _rg_lru_gates(p, x)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return [al * ar, br + ar * bl]

    _, h = _associative_scan(combine, [a, gx])
    return h.to(x.dtype)


def rg_lru_step(p, x, h):
    """x: [B,1,W], h: [B,W] → (y [B,1,W], h')."""
    a, gx = _rg_lru_gates(p, x[:, 0])
    h2 = a * h.float() + gx
    return h2[:, None].to(x.dtype), h2.to(h.dtype)


def rec_mix(p, x, cfg: ModelConfig, state=None,
            use_kernel_conv: Optional[bool] = None):
    """The Griffin recurrent mixing block.  state: {'h','conv'} (decode)
    or None (the full sequence from zero history: the conv over
    ``[B, S+cw-1, W]``, then ``rg_lru_scan``) → (x + y, new state or
    None)."""
    xn = L.norm(p["ln"], x, cfg)
    dt = x.dtype
    gate = F.gelu(torch.einsum("bsd,dw->bsw", xn, p["w_gate"].to(dt)),
                  approximate="tanh")
    gate = constrain(gate, "batch", "seq", "rnn")
    u = torch.einsum("bsd,dw->bsw", xn, p["w_x"].to(dt))
    u = constrain(u, "batch", "seq", "rnn")
    u, conv_state = causal_conv(u, p["conv_w"], p["conv_b"],
                                None if state is None else state["conv"],
                                use_kernel=use_kernel_conv)
    if state is None:
        h = rg_lru_scan(p, u)
        new_state = None
    else:
        h, h_new = rg_lru_step(p, u, state["h"])
        new_state = {"h": h_new, "conv": conv_state}
    y = torch.einsum("bsw,wd->bsd", gate * h, p["w_out"].to(dt))
    y = constrain(y, "batch", "seq", "embed")
    return x + y, new_state


def attn_mix(p, x, cfg: ModelConfig, positions, cache=None):
    """The local-attention mixing block."""
    xn = L.norm(p["ln"], x, cfg)
    h, nc = L.attention(p["attn"], xn, cfg, mode="causal",
                        window=cfg.local_window, positions=positions,
                        cache=cache)
    return x + h, nc


def ffn_block(p, x, cfg: ModelConfig):
    """The feed-forward block with its residual."""
    return x + L.mlp(p["mlp"], L.norm(p["ln"], x, cfg), cfg)


def _block_fwd(bp, x, t, cfg, positions,
               use_kernel_conv: Optional[bool] = None):
    if t == "rec":
        x, _ = rec_mix(bp["mix"], x, cfg, use_kernel_conv=use_kernel_conv)
    else:
        x, _ = attn_mix(bp["mix"], x, cfg, positions)
    return ffn_block(bp["ffn"], x, cfg)


def forward(params, tokens, cfg: ModelConfig,
            prefix_embeds: Optional[torch.Tensor] = None,
            use_kernel_conv: Optional[bool] = None):
    """tokens [B, S] → (final-normed hidden [B, S, D], aux loss 0.0 in
    f32).  Each full cycle runs under ``L.remat_wrap(cfg)``, as the JAX
    package's scanned cycle body; the tail's blocks run bare.
    ``prefix_embeds`` is ignored, as there."""
    x = L.embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    pat = pattern_of(cfg)
    P = len(pat)
    n_cycles, tail = _cycle_split(cfg)

    def cycle_fwd(cyc, x):
        for bp, t in zip(cyc, pat):
            x = _block_fwd(bp, x, t, cfg, positions, use_kernel_conv)
        return x

    body = L.remat_wrap(cfg)(cycle_fwd)
    blocks = params["blocks"]
    for c in range(n_cycles):
        x = body(blocks[c * P:(c + 1) * P], x)
    for p in range(tail):
        x = _block_fwd(blocks[n_cycles * P + p], x, pat[p], cfg, positions,
                       use_kernel_conv)
    x = L.norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# -- decode -------------------------------------------------------------------
def _block_state(cfg: ModelConfig, t: str, batch: int, cache_len: int,
                 device):
    w = cfg.rnn_width or cfg.d_model
    hd = cfg.resolved_head_dim
    dt = L.cdtype(cfg)
    if t == "rec":
        return {"h": torch.zeros((batch, w), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dt,
                                    device=device)}
    shape = (batch, cache_len, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    """One state per layer (recurrent: ``h`` f32 and ``conv`` in the
    compute dtype; attention: the rolling K/V buffer of ``cache_len`` ≤
    local_window slots) and the shared position ``pos``, an int."""
    return {"blocks": [_block_state(cfg, t, batch, cache_len, device)
                       for t in block_types(cfg)],
            "pos": 0}


def _block_decode(bp, x, st, t, cfg, positions, pos,
                  use_kernel_conv: Optional[bool] = None):
    if t == "rec":
        x, ns = rec_mix(bp["mix"], x, cfg, state=st,
                        use_kernel_conv=use_kernel_conv)
    else:
        lcache = {"k": st["k"], "v": st["v"], "pos": pos}
        x, nc = attn_mix(bp["mix"], x, cfg, positions, cache=lcache)
        ns = {"k": nc["k"], "v": nc["v"]}
    return ffn_block(bp["ffn"], x, cfg), ns


def decode_step(params, cache, tokens, cfg: ModelConfig,
                use_kernel_conv: Optional[bool] = None):
    """tokens [B, S] → (logits [B, S, vocab], cache').  The attention
    buffers of ``cache`` are written in place; the recurrent states of
    ``cache'`` are new tensors."""
    x = L.embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    pos = int(cache["pos"])
    positions = (pos + torch.arange(S, device=x.device)).expand(B, S)
    new_blocks: List[Dict] = []
    for bp, st, t in zip(params["blocks"], cache["blocks"], block_types(cfg)):
        x, ns = _block_decode(bp, x, st, t, cfg, positions, pos,
                              use_kernel_conv)
        new_blocks.append(ns)
    x = L.norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, {"blocks": new_blocks, "pos": pos + S}
