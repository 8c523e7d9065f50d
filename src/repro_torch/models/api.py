"""Family-dispatching model API: init / param count / forward / loss /
decode / caches (the JAX package's ``models/api.py``).

``cfg.family`` picks the backbone module: ``transformer`` (dense, moe,
vlm), ``griffin`` (hybrid), ``xlstm`` (ssm), ``encdec`` (audio).  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsl import resolve_device
from repro_torch.sharding import constrain

from . import encdec, griffin, transformer, xlstm
from . import layers as L

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "hybrid": griffin, "ssm": xlstm, "audio": encdec}


def module_for(cfg: ModelConfig):
    """The backbone module of ``cfg.family``."""
    if cfg.family not in _FAMILY:
        raise ValueError(f"unknown model family '{cfg.family}' ({cfg.name}); "
                         f"have {sorted(_FAMILY)}")
    return _FAMILY[cfg.family]


def _conv_kw(use_kernel_conv: Optional[bool]) -> Dict:
    """The ``use_kernel_conv`` argument of the families with a temporal
    conv (``griffin``), passed only when set."""
    return {} if use_kernel_conv is None else {"use_kernel_conv": use_kernel_conv}


def init_params(cfg: ModelConfig, *, device=None, seed: int = 0):
    """Random parameters on ``device`` (None: the card; ``"meta"``: shapes
    only), drawn from a ``torch.Generator`` on that device seeded with
    ``seed``.  They differ from the JAX package's draws for the same seed;
    ``interop.params_from_jax`` carries those across."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    return module_for(cfg).init_params(gen, cfg, dev)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def param_count(cfg: ModelConfig) -> int:
    """Number of parameters, counted from shapes on the ``meta`` device
    (nothing is allocated)."""
    return sum(t.numel() for _, t in _leaves(init_params(cfg, device="meta")))


def active_param_count(cfg: ModelConfig) -> int:
    """MoE: experts count at top_k/E; everything else fully active."""
    total = 0
    for path, t in _leaves(init_params(cfg, device="meta")):
        n = t.numel()
        if cfg.moe and "moe" in path and "router" not in path:
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total


def stacked_ndims(cfg: ModelConfig, params):
    """The rank each leaf of ``params`` has in the JAX package's layout
    (the optimizer's weight-decay rule reads it)."""
    return module_for(cfg).stacked_ndims(cfg, params)


def forward_hidden(cfg: ModelConfig, params, batch: Dict,
                   use_kernel_conv: Optional[bool] = None):
    """→ (hidden_for_logits [B, S_tok, D], aux_loss)."""
    mod = module_for(cfg)
    if cfg.family == "audio":
        return mod.forward(params, batch, cfg)
    prefix = batch.get("patch_embeds")
    hid, aux = mod.forward(params, batch["tokens"], cfg, prefix_embeds=prefix,
                           **_conv_kw(use_kernel_conv))
    if prefix is not None:
        hid = hid[:, prefix.shape[1]:]
    return hid, aux


def _ce_from_logits(logits, labels):
    """Mean token cross-entropy, f32 logsumexp."""
    lg = L.wide(logits)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


def loss_fn(cfg: ModelConfig, params, batch: Dict,
            use_kernel_conv: Optional[bool] = None):
    """→ (loss, metrics).  Vocab-heavy configs use sequence-chunked CE,
    each chunk under ``torch.utils.checkpoint``, so the [B,S,V] logits
    never materialize (cfg.logits_chunk)."""
    hid, aux = forward_hidden(cfg, params, batch, use_kernel_conv)
    labels = batch["labels"]
    embed_p = params["embed"]

    if cfg.logits_chunk:
        C = cfg.logits_chunk
        B, S, D = hid.shape
        pad = (-S) % C
        if pad:
            hid = F.pad(hid, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=0)
        n = hid.shape[1] // C
        valid = (torch.arange(hid.shape[1], device=hid.device) < S).reshape(n, C)

        def chunk_loss(h, y, v):
            logits = L.wide(L.unembed(embed_p, h, cfg))
            logits = constrain(logits, "batch", None, "vocab")
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1, y.long()[..., None])[..., 0]
            return ((lse - picked) * v[None]).sum()

        total = torch.zeros((), dtype=L.wide_dtype(hid.dtype), device=hid.device)
        for i in range(n):
            sl = slice(i * C, (i + 1) * C)
            h = constrain(hid[:, sl], "batch", None, "embed")
            total = total + _ckpt.checkpoint(chunk_loss, h,
                                             labels[:, sl], valid[i],
                                             use_reentrant=False)
        ce = total / (B * S)
    else:
        logits = L.unembed(embed_p, hid, cfg)
        ce = _ce_from_logits(logits, labels)

    loss = ce + aux
    return loss, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device=None,
               **kw):
    """The decode cache of ``batch`` rows on ``device`` (None: the card);
    ``kw`` goes to the family's ``init_cache`` (audio: ``enc_len``)."""
    return module_for(cfg).init_cache(cfg, batch, cache_len,
                                      resolve_device(device), **kw)


def decode_step(cfg: ModelConfig, params, cache, tokens,
                use_kernel_conv: Optional[bool] = None):
    """One decode step: tokens [B, S] → (logits [B, S, vocab], cache')."""
    return module_for(cfg).decode_step(params, cache, tokens, cfg,
                                       **_conv_kw(use_kernel_conv))


def decode_cache_len(cfg: ModelConfig, context_len: int) -> int:
    """Rolling-buffer size: SWA archs bound it by the window."""
    if cfg.family == "hybrid":
        return min(cfg.local_window or context_len, context_len)
    if cfg.family == "ssm":
        return 0
    if cfg.window:
        return min(cfg.window, context_len)
    return context_len
