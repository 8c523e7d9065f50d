"""Deterministic synthetic token pipeline (a copy of the JAX package's
``train/data.py``, numpy only: the same batches for the same seed and
step).

Stateless: ``batch(step)`` is a pure function of (seed, step) via the
counter-based Philox generator, so a restarted job replays the exact same
stream.

The token stream is *learnable* (affine next-token structure + noise) so
training-loss decrease is a meaningful signal in tests and examples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05     # fraction of tokens replaced with uniform noise


class SyntheticLM:
    """Markov-ish synthetic LM data: x_{t+1} = (a·x_t + c) mod V with
    occasional uniform-noise tokens.  labels = next token."""

    def __init__(self, c: DataConfig):
        self.c = c
        # odd multiplier → full-period affine map over Z_V when V is 2^k;
        # otherwise still a learnable deterministic map
        self.a = 5
        self.add = 17

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.c
        rng = np.random.Generator(np.random.Philox(key=c.seed, counter=step))
        B, S = c.global_batch, c.seq_len
        x0 = rng.integers(0, c.vocab, size=(B, 1))
        toks = [x0]
        for _ in range(S):
            toks.append((self.a * toks[-1] + self.add) % c.vocab)
        seq = np.concatenate(toks, axis=1)          # [B, S+1]
        noise_mask = rng.random((B, S + 1)) < c.noise
        noise = rng.integers(0, c.vocab, size=(B, S + 1))
        seq = np.where(noise_mask, noise, seq)
        return {"tokens": seq[:, :S].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}


def make_batch_fn(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                  global_batch: Optional[int] = None,
                  seq_len: Optional[int] = None):
    """Batch generator: ``batch(step)`` → {tokens, labels} (numpy int32),
    plus the stub modality frontends' embeddings of the families that
    have them."""
    B = global_batch or shape.global_batch
    S = seq_len or shape.seq_len
    if cfg.family == "audio":
        S_tok = S // 2
    elif cfg.family == "vlm":
        S_tok = S - cfg.n_prefix_tokens
    else:
        S_tok = S
    lm = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S_tok,
                                global_batch=B, seed=seed))

    def batch(step: int) -> Dict[str, np.ndarray]:
        out = dict(lm.batch(step))
        rng = np.random.Generator(np.random.Philox(key=seed + 1,
                                                   counter=step))
        if cfg.family == "audio":
            out["frame_embeds"] = rng.standard_normal(
                (B, S // 2, cfg.d_model)).astype(np.float32)
        elif cfg.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
        return out

    return batch
