"""Family-dispatching model API: init / param count / decode / caches (the
decode subset of the JAX package's ``models/api.py``).

``cfg.family`` picks the backbone module; the port runs the ``hybrid``
family (Griffin / RecurrentGemma).  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsl import not_ported, resolve_device

from . import griffin

_FAMILY = {"hybrid": griffin}


def module_for(cfg: ModelConfig):
    """The backbone module of ``cfg.family``."""
    if cfg.family not in _FAMILY:
        raise not_ported(f"the '{cfg.family}' model family ({cfg.name})",
                         "queue 1, item 11")
    return _FAMILY[cfg.family]


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


def param_count(cfg: ModelConfig) -> int:
    """Number of parameters, counted from shapes on the ``meta`` device
    (nothing is allocated)."""
    params = init_params(cfg, device="meta")
    total = 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for x in t.values():
                walk(x)
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        else:
            total += t.numel()
    walk(params)
    return total


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device=None):
    """The decode cache of ``batch`` rows on ``device`` (None: the card)."""
    return module_for(cfg).init_cache(cfg, batch, cache_len,
                                      resolve_device(device))


def decode_step(cfg: ModelConfig, params, cache, tokens,
                use_kernel_conv: Optional[bool] = None):
    """One decode step: tokens [B, S] → (logits [B, S, vocab], cache')."""
    return module_for(cfg).decode_step(params, cache, tokens, cfg,
                                       use_kernel_conv=use_kernel_conv)


def decode_cache_len(cfg: ModelConfig, context_len: int) -> int:
    """Rolling-buffer size: SWA archs bound it by the window."""
    if cfg.family == "hybrid":
        return min(cfg.local_window or context_len, context_len)
    if cfg.family == "ssm":
        return 0
    if cfg.window:
        return min(cfg.window, context_len)
    return context_len
