"""xLSTM: mLSTM (matrix memory, chunkwise-parallel) + sLSTM (scalar memory,
sequential scan) blocks [arXiv:2405.04517]: the JAX package's
``models/xlstm.py``.

Training uses the chunkwise form of the mLSTM recurrence (linear-attention
style: the inter-chunk state carried by a loop over chunks; intra-chunk
causal matmul), exact w.r.t. the sequential recurrence up to the
log-domain stabilizer.  Decode keeps O(1) state per layer (mLSTM: C
[B,H,dk,dv], n [B,H,dk], m [B,H]; sLSTM: c, n, m [B,H,hd]).  The gate
math (log-sigmoid, cumulative sums and maxima, the stabilizers) runs in
f32 (``L.wide``: f64 in an f64 run), q/k/v in the compute dtype, as
there.

sLSTM blocks (every ``slstm_every``-th layer): their exponential-gate
normalizer is a serial dependency, which the sequence form evaluates as
two associative scans (a max-plus one for the stabilizer, then linear
ones), the decode step one step at a time.

The JAX package stacks the full cycles' parameters and scans them; here
``params["blocks"]`` holds one dict per layer, in layer order (as in
``griffin``), and each full cycle runs under ``L.remat_wrap(cfg)``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import constrain

from . import layers as L
from .griffin import _associative_scan
from .transformer import _ranks


def block_types(cfg: ModelConfig) -> List[str]:
    """Type of every layer, in order."""
    n = cfg.slstm_every or 0
    return ["slstm" if (n and (i + 1) % n == 0) else "mlstm"
            for i in range(cfg.n_layers)]


def pattern_of(cfg: ModelConfig) -> Tuple[str, ...]:
    """The repeating block cycle: (mlstm ×(k−1), slstm) for
    slstm_every=k, or a single mlstm."""
    P = cfg.slstm_every or 1
    return tuple(block_types(cfg)[:P])


def _cycle_split(cfg: ModelConfig) -> Tuple[int, int]:
    P = len(pattern_of(cfg))
    return cfg.n_layers // P, cfg.n_layers % P


def _heads(cfg):
    return cfg.n_heads, cfg.resolved_head_dim


def init_mlstm_block(gen, cfg: ModelConfig, device):
    """An mLSTM block: norm, q/k/v, exponential input and forget gates
    (forget bias 3: long memory), output gate and projection."""
    d = cfg.d_model
    H, hd = _heads(cfg)
    dt = L.pdtype(cfg)
    return {
        "ln": L.init_norm(d, cfg, device),
        "wq": L.dense_init(gen, (d, H, hd), dt, device),
        "wk": L.dense_init(gen, (d, H, hd), dt, device),
        "wv": L.dense_init(gen, (d, H, hd), dt, device),
        "wi": L.dense_init(gen, (d, H), dt, device),
        "wf": L.dense_init(gen, (d, H), dt, device),
        "bf": torch.full((H,), 3.0, dtype=dt, device=device),
        "wo_gate": L.dense_init(gen, (d, H, hd), dt, device),
        "wo": L.dense_init(gen, (H, hd, d), dt, device,
                           scale=(H * hd) ** -0.5),
    }


def init_slstm_block(gen, cfg: ModelConfig, device):
    """An sLSTM block: norm, cell input, input/forget/output gates per
    unit, projection."""
    d = cfg.d_model
    H, hd = _heads(cfg)
    dt = L.pdtype(cfg)
    return {
        "ln": L.init_norm(d, cfg, device),
        "wz": L.dense_init(gen, (d, H, hd), dt, device),
        "wi": L.dense_init(gen, (d, H, hd), dt, device),
        "wf": L.dense_init(gen, (d, H, hd), dt, device),
        "wo_gate": L.dense_init(gen, (d, H, hd), dt, device),
        "bf": torch.full((H, hd), 3.0, dtype=dt, device=device),
        "wo": L.dense_init(gen, (H, hd, d), dt, device,
                           scale=(H * hd) ** -0.5),
    }


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, device):
    """Random parameters drawn from ``gen`` onto ``device`` (on ``meta``:
    shapes only), one block dict per layer."""
    init = {"mlstm": init_mlstm_block, "slstm": init_slstm_block}
    return {"embed": L.init_embedding(gen, cfg, device),
            "blocks": [init[t](gen, cfg, device) for t in block_types(cfg)],
            "final_norm": L.init_norm(cfg.d_model, cfg, device)}


def stacked_ndims(cfg: ModelConfig, params):
    """The rank each leaf of ``params`` has in the JAX package's layout,
    where a full cycle's leaves are stacked on a leading axis (one more
    than here) and the tail's and the rest are not."""
    stacked = _cycle_split(cfg)[0] * len(pattern_of(cfg))
    return {"embed": _ranks(params["embed"], 0),
            "blocks": [_ranks(b, int(i < stacked))
                       for i, b in enumerate(params["blocks"])],
            "final_norm": _ranks(params["final_norm"], 0)}


# --------------------------------------------------------------------------
# mLSTM chunkwise
# --------------------------------------------------------------------------
def _mlstm_proj(p, xn):
    dt = xn.dtype
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", xn, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", xn, p["wv"].to(dt))
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "heads", "head_dim")
    v = constrain(v, "batch", "seq", "heads", "head_dim")
    i_pre = L.wide(torch.einsum("bsd,dh->bsh", xn, p["wi"].to(dt)))
    f_pre = L.wide(torch.einsum("bsd,dh->bsh", xn, p["wf"].to(dt))
                   + p["bf"].to(dt))
    og = torch.sigmoid(torch.einsum("bsd,dhk->bshk", xn, p["wo_gate"].to(dt)))
    return q, k, v, i_pre, f_pre, og


def mlstm_chunkwise(p, x, cfg: ModelConfig):
    """x: [B,S,D] → x + the block's output [B,S,D]; the sequence padded to
    a multiple of ``chunk = min(cfg.chunk, S)`` and the result sliced
    back."""
    B, S, D = x.shape
    H, hd = _heads(cfg)
    xn = L.norm(p["ln"], x, cfg)
    C = min(cfg.chunk, S)
    pad = (-S) % C
    if pad:
        xn = F.pad(xn, (0, 0, 0, pad))
    Sp = xn.shape[1]
    q, k, v, i_pre, f_pre, og = _mlstm_proj(p, xn)
    scale = hd ** -0.5
    logf = F.logsigmoid(f_pre)                          # [B,Sp,H]
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))

    # carried state is stabilized: true_C = Cst · exp(mst)
    wd = L.wide_dtype(x.dtype)
    Cst = torch.zeros((B, H, hd, hd), dtype=wd, device=x.device)
    nst = torch.zeros((B, H, hd), dtype=wd, device=x.device)
    mst = torch.full((B, H), -1e30, dtype=wd, device=x.device)
    outs = []
    for c in range(Sp // C):
        sl = slice(c * C, (c + 1) * C)
        qb, kb, vb, ib, fb = q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], logf[:, sl]
        fcum = torch.cumsum(fb, dim=1)                  # [B,C,H] Σ_{r≤t} logf
        ftot = fcum[:, -1]                              # [B,H]
        g = ib - fcum                                   # i_s − fcum_s
        b = torch.cummax(g, dim=1).values               # running max over s≤t
        Mt = torch.maximum(mst[:, None], b)             # [B,C,H]
        m_t = fcum + Mt                                 # per-t stabilizer
        # inter-chunk: q_t reads the previous state decayed by exp(fcum_t)
        w_state = torch.exp(mst[:, None] - Mt)          # ≤ 1
        qs = qb * scale
        inter = torch.einsum("bchk,bhkl->bchl", qs, Cst.to(qb.dtype))
        inter = inter * w_state[..., None].to(qb.dtype)
        n_inter = torch.einsum("bchk,bhk->bch", L.wide(qs), nst) * w_state
        # intra-chunk causal: weight(t,s) = exp(g_s − Mt_t) for s ≤ t
        dmat = g[:, None] - Mt[:, :, None]              # [B,t,s,H]
        wmat = torch.where(causal[None, :, :, None], torch.exp(dmat),
                           torch.zeros((), device=x.device))
        scores = torch.einsum("bchk,bshk->bcsh", qs, kb)
        sw = L.wide(scores) * wmat
        intra = torch.einsum("bcsh,bshl->bchl", sw.to(vb.dtype), vb)
        n_intra = sw.sum(dim=2)                         # [B,C,H]
        num = inter + intra
        den = torch.abs(n_inter + n_intra)
        den = torch.maximum(den, torch.exp(-m_t))
        outs.append(num / den[..., None].to(num.dtype))
        # state update to the end of the chunk: stabilizer m' = ftot + Mend
        Mend = torch.maximum(mst, b[:, -1])             # [B,H]
        w_k = torch.exp(g - Mend[:, None])              # ≤ 1  [B,C,H]
        kv = torch.einsum("bchk,bchl->bhkl", L.wide(kb) * w_k[..., None],
                          L.wide(vb))
        decay = torch.exp(mst - Mend)
        Cst = Cst * decay[..., None, None] + kv
        nst = nst * decay[..., None] + torch.einsum("bchk,bch->bhk",
                                                    L.wide(kb), w_k)
        mst = ftot + Mend
    out = torch.cat(outs, dim=1)[:, :S]
    out = out * og[:, :S].to(out.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    # under a mesh: the heads' partial sums summed before the residual
    return x + constrain(y, "batch", "seq", "embed")


def mlstm_step(p, x, state, cfg: ModelConfig):
    """Decode: x [B,1,D]; state (C, n, m) → (x + y, state')."""
    H, hd = _heads(cfg)
    xn = L.norm(p["ln"], x, cfg)
    q, k, v, i_pre, f_pre, og = _mlstm_proj(p, xn)
    q, k, v, og = q[:, 0], k[:, 0], v[:, 0], og[:, 0]
    i_t, logf = i_pre[:, 0], F.logsigmoid(f_pre[:, 0])
    Cst, nst, mst = state
    m_new = torch.maximum(logf + mst, i_t)
    wf = torch.exp(logf + mst - m_new)
    wi = torch.exp(i_t - m_new)
    kv = torch.einsum("bhk,bhl->bhkl", L.wide(k) * wi[..., None], L.wide(v))
    C2 = Cst * wf[..., None, None] + kv
    n2 = nst * wf[..., None] + L.wide(k) * wi[..., None]
    qs = L.wide(q * (hd ** -0.5))
    num = torch.einsum("bhk,bhkl->bhl", qs, C2)
    den = torch.abs(torch.einsum("bhk,bhk->bh", qs, n2))
    den = torch.maximum(den, torch.exp(-m_new))
    out = (num / den[..., None]).to(x.dtype) * og
    y = constrain(torch.einsum("bhk,hkd->bd", out, p["wo"].to(x.dtype)),
                  "batch", "embed")
    return x + y[:, None], [C2, n2, m_new]


# --------------------------------------------------------------------------
# sLSTM (sequential)
# --------------------------------------------------------------------------
def _slstm_proj(p, xn):
    dt = xn.dtype
    z = torch.einsum("bsd,dhk->bshk", xn, p["wz"].to(dt))
    i = L.wide(torch.einsum("bsd,dhk->bshk", xn, p["wi"].to(dt)))
    f = L.wide(torch.einsum("bsd,dhk->bshk", xn, p["wf"].to(dt))
               + p["bf"].to(dt))
    o = torch.sigmoid(torch.einsum("bsd,dhk->bshk", xn, p["wo_gate"].to(dt)))
    return z, i, f, o


def _slstm_cell(state, tz, i_t, logf):
    """One step from (c, n, m) with tanh(z_t), i_t, log σ(f_t), all f32
    (the elementwise maps of the inputs taken outside the loop, the same
    values) → ((c', n', m'), h)."""
    c, n, m = state
    a = logf + m
    m2 = torch.maximum(a, i_t)
    wf = torch.exp(a - m2)
    wi = torch.exp(i_t - m2)
    c2 = wf * c + wi * tz
    n2 = wf * n + wi
    return (c2, n2, m2), c2 / torch.clamp(n2, min=1e-6)


def _slstm_state0(cfg, B, device):
    H, hd = _heads(cfg)
    wd = L.wide_dtype(L.cdtype(cfg))
    c0 = torch.zeros((B, H, hd), dtype=wd, device=device)
    return [c0, c0, torch.full((B, H, hd), -1e30, dtype=wd, device=device)]


def slstm_seq(p, x, cfg: ModelConfig):
    """x: [B,S,D] → x + the block's output.  The recurrence in two
    associative scans over S (``griffin._associative_scan``, O(log S)
    depth): the stabilizer m_t = max(log σ(f_t) + m_{t−1}, i_t) as a
    max-plus scan, then c and n as linear scans with the gates it fixes
    (the JAX package's serial ``lax.scan`` computes the same recurrence;
    sums associate otherwise, a few f32 ulp apart)."""
    B, S, D = x.shape
    xn = L.norm(p["ln"], x, cfg)
    z, i, f, o = _slstm_proj(p, xn)
    tz, logf = torch.tanh(L.wide(z)), F.logsigmoid(f)

    def maxplus(l, r):
        return [l[0] + r[0], torch.maximum(l[1] + r[0], r[1])]

    # from m = -1e30 the first term never wins: m_t is the scan's max part
    _, m = _associative_scan(maxplus, [logf, i])
    m_prev = F.pad(m[:, :-1], (0, 0, 0, 0, 1, 0), value=-1e30)
    wf = torch.exp(logf + m_prev - m)
    wi = torch.exp(i - m)

    def linear(l, r):
        return [l[0] * r[0], r[0] * l[1] + r[1], r[0] * l[2] + r[2]]

    _, c, n = _associative_scan(linear, [wf, wi * tz, wi])
    h = (c / torch.clamp(n, min=1e-6)).to(x.dtype) * o
    y = torch.einsum("bshk,hkd->bsd", h, p["wo"].to(x.dtype))
    return x + constrain(y, "batch", "seq", "embed")


def slstm_step(p, x, state, cfg: ModelConfig):
    """Decode: x [B,1,D]; state (c, n, m) → (x + y, state')."""
    xn = L.norm(p["ln"], x, cfg)
    z, i, f, o = _slstm_proj(p, xn)
    state, h = _slstm_cell(state, torch.tanh(L.wide(z[:, 0])), i[:, 0],
                           F.logsigmoid(f[:, 0]))
    y = constrain(torch.einsum("bhk,hkd->bd", h.to(x.dtype) * o[:, 0],
                               p["wo"].to(x.dtype)), "batch", "embed")
    return x + y[:, None], list(state)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
_SEQ = {"mlstm": mlstm_chunkwise, "slstm": slstm_seq}
_STEP = {"mlstm": mlstm_step, "slstm": slstm_step}


def forward(params, tokens, cfg: ModelConfig,
            prefix_embeds: Optional[torch.Tensor] = None):
    """tokens [B, S] → (final-normed hidden [B, S, D], aux loss 0.0 in
    f32).  ``prefix_embeds`` is ignored, as in the JAX package."""
    x = L.embed(params["embed"], tokens, cfg)
    pat = pattern_of(cfg)
    P = len(pat)
    n_cycles, tail = _cycle_split(cfg)

    def cycle_fwd(cyc, x):
        for bp, t in zip(cyc, pat):
            x = _SEQ[t](bp, x, cfg)
        return x

    body = L.remat_wrap(cfg)(cycle_fwd)
    blocks = params["blocks"]
    for c in range(n_cycles):
        x = body(blocks[c * P:(c + 1) * P], x)
    for p in range(tail):
        x = _SEQ[pat[p]](blocks[n_cycles * P + p], x, cfg)
    x = L.norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _block_state(cfg: ModelConfig, t: str, batch: int, device):
    H, hd = _heads(cfg)
    if t == "mlstm":
        wd = L.wide_dtype(L.cdtype(cfg))
        return [torch.zeros((batch, H, hd, hd), dtype=wd, device=device),
                torch.zeros((batch, H, hd), dtype=wd, device=device),
                torch.full((batch, H), -1e30, dtype=wd, device=device)]
    return _slstm_state0(cfg, batch, device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    """One recurrent state per layer (f32; its size does not depend on the
    context, ``cache_len`` is ignored) and the position ``pos``."""
    return {"blocks": [_block_state(cfg, t, batch, device)
                       for t in block_types(cfg)],
            "pos": 0}


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """tokens [B, 1] → (logits [B, 1, V], cache' with new states)."""
    x = L.embed(params["embed"], tokens, cfg)
    blocks = []
    for bp, st, t in zip(params["blocks"], cache["blocks"], block_types(cfg)):
        x, ns = _STEP[t](bp, x, st, cfg)
        blocks.append(ns)
    x = L.norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, {"blocks": blocks, "pos": int(cache["pos"]) + 1}
