"""Assigned input shapes × architecture → input specs (the JAX package's
``configs/shapes.py``):

  train_4k      seq_len=4096    global_batch=256   (training step)
  prefill_32k   seq_len=32768   global_batch=32    (inference prefill)
  decode_32k    seq_len=32768   global_batch=128   (one-token decode, KV
                                                    cache of seq_len)
  long_500k     seq_len=524288  global_batch=1     (long-context decode;
                                                    sub-quadratic archs only)

``input_specs(cfg, shape)`` gives every model input as a tensor on the
``meta`` device (shape and dtype, nothing allocated), the port's
counterpart of the JAX package's ``jax.ShapeDtypeStruct`` stand-ins; a
decode cell's cache is the port's cache layout (one state per layer).
``make_host_batch`` fills the same specs with numbers (small configs
only).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .base import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "applicable", "input_specs",
           "batch_dims", "make_host_batch"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def _subquadratic(cfg: ModelConfig) -> bool:
    """Archs with O(window)/O(1) decode state: SSM, hybrid, or SWA."""
    return cfg.family in ("ssm", "hybrid") or bool(cfg.window)


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skip): ``long_500k`` needs sub-quadratic
    attention; pure full-attention archs skip it.  (No encoder-only archs
    are assigned, so decode shapes run everywhere else.)"""
    if shape.name == "long_500k" and not _subquadratic(cfg):
        return False, ("pure full-attention arch: 500k-context decode has "
                       "no sub-quadratic structure (documented skip)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """Meta-tensor stand-ins for every input of this cell's step:
    train → the loss batch {tokens, labels, [patch_embeds|frame_embeds]};
    prefill → {tokens, [patch_embeds|frame_embeds]}; decode → {tokens
    [B, 1], cache}."""
    from repro_torch.models import api  # local import to avoid cycles

    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            # enc-dec split: enc_frames = dec_tokens = S/2
            T = S // 2
            specs = {"frame_embeds": spec((B, T, cfg.d_model), dt),
                     "tokens": spec((B, T), i32)}
            if shape.kind == "train":
                specs["labels"] = spec((B, T), i32)
            return specs
        if cfg.family == "vlm":
            P = cfg.n_prefix_tokens
            St = S - P
            specs = {"patch_embeds": spec((B, P, cfg.d_model), dt),
                     "tokens": spec((B, St), i32)}
            if shape.kind == "train":
                specs["labels"] = spec((B, St), i32)
            return specs
        specs = {"tokens": spec((B, S), i32)}
        if shape.kind == "train":
            specs["labels"] = spec((B, S), i32)
        return specs

    # decode: one new token against a cache of context S
    cache_len = api.decode_cache_len(cfg, S)
    kw = {"enc_len": 1500} if cfg.family == "audio" else {}
    cache = api.init_cache(cfg, B, cache_len, device="meta", **kw)
    return {"tokens": spec((B, 1), i32), "cache": cache}


def batch_dims(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, int]:
    """Leading batch dim of every input-spec leaf group (for sharding)."""
    return {"tokens": 0, "labels": 0, "patch_embeds": 0, "frame_embeds": 0}


def make_host_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                    *, device=None) -> Dict:
    """Concrete inputs matching ``input_specs`` as tensors on ``device``
    (None: the card), for reduced smoke configs only: token ids and
    embeddings drawn by ``numpy.random.default_rng(seed)`` in the JAX
    package's order (int32 ids, f32 embeddings: the same numbers as its
    ``make_host_batch``); a decode cell's cache is ``api.init_cache``'s."""
    import numpy as np

    from repro_torch.core.dsl import resolve_device
    from repro_torch.models import api

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if name == "cache":
            cache_len = api.decode_cache_len(cfg, shape.seq_len)
            kw = {"enc_len": 1500} if cfg.family == "audio" else {}
            out[name] = api.init_cache(cfg, shape.global_batch, cache_len,
                                       device=dev, **kw)
        elif spec.dtype == torch.int32:
            out[name] = torch.from_numpy(rng.integers(
                0, cfg.vocab, tuple(spec.shape)).astype(np.int32)).to(dev)
        else:
            out[name] = torch.from_numpy(rng.standard_normal(
                tuple(spec.shape)).astype(np.float32)).to(dev)
    return out
