"""Batched serving: one-token decode steps over the model's cache (the JAX
package's ``serving/serve_loop.py``).

``make_serve_step`` builds the single-token step; ``Generator`` drives
end-to-end greedy/temperature generation; ``BatchServer`` is a
wave-scheduling batch server (requests are grouped into fixed-size
left-padded waves that share one cache — per-slot position bookkeeping via
the attention mask's ``kp >= 0`` guard on never-written slots).

Greedy decoding (temperature 0) is the parity target with the JAX package.
Temperature sampling draws from a ``torch.Generator`` seeded with
``GenConfig.seed``: a different random stream from ``jax.random``'s, so
sampled tokens differ from the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """Generation settings: new tokens per request, temperature (0 →
    greedy) and the sampling seed."""
    max_new_tokens: int = 16
    temperature: float = 0.0          # 0 → greedy
    seed: int = 0


def make_serve_step(cfg: ModelConfig, sample: bool = True,
                    temperature: float = 1.0):
    """→ ``serve_step(params, cache, tokens[B,1], generator) ->
    (next_tokens [B,1], cache')``.  Greedy when ``generator`` is None,
    temperature sampling from it otherwise.  With ``sample=False`` returns
    the f32 logits of the last position instead of tokens."""
    temperature = max(float(temperature), 1e-6)

    def serve_step(params, cache, tokens, generator=None):
        logits, cache2 = api.decode_step(cfg, params, cache, tokens)
        logits = logits[:, -1].float()                   # [B, V]
        if not sample:
            return logits, cache2
        if generator is None:
            nxt = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return nxt[:, None].to(torch.int32), cache2

    return serve_step


class Generator:
    """End-to-end generation for one batch of same-length prompts, on the
    device of ``params``.  ``cache`` holds the last call's final decode
    cache."""

    def __init__(self, cfg: ModelConfig, params, gen: GenConfig = GenConfig()):
        self.cfg, self.params, self.gen = cfg, params, gen
        self.device = params["embed"]["tok"].device
        self._step = make_serve_step(cfg, temperature=gen.temperature or 1.0)
        self.cache = None

    def generate(self, prompts: np.ndarray,
                 frame_embeds: Optional[np.ndarray] = None,
                 max_new: Optional[int] = None) -> np.ndarray:
        """prompts: [B, S] int32 → [B, S + max_new] (greedy when
        temperature == 0).  The audio family (encoder-decoder) takes its
        encoder input ``frame_embeds`` [B, T, D]: the prompt is decoded
        against a cache of the encoder output's cross K/V
        (``encdec.build_cache``).  ``max_new`` overrides the config's
        ``max_new_tokens`` per call (the batch server varies it per wave
        without rebuilding the generator)."""
        cfg, gen = self.cfg, self.gen
        if max_new is not None:
            gen = dataclasses.replace(gen, max_new_tokens=int(max_new))
        B, S = prompts.shape
        cache_len = api.decode_cache_len(cfg, S + gen.max_new_tokens)
        if cfg.family == "audio":
            if frame_embeds is None:
                raise ValueError(f"{cfg.name}: the audio family decodes "
                                 f"against frame_embeds [B, T, D]")
            mod = api.module_for(cfg)
            enc = mod.encode(self.params, torch.as_tensor(
                np.asarray(frame_embeds), device=self.device), cfg)
            cache = mod.build_cache(self.params, enc, cfg, B, cache_len)
        else:
            cache = api.init_cache(cfg, B, cache_len, device=self.device)
        toks = torch.as_tensor(np.asarray(prompts, np.int32),
                               device=self.device)
        sampler = None
        if gen.temperature > 0:
            sampler = torch.Generator(device=self.device).manual_seed(gen.seed)
        out = [toks]
        # feed the prompt token by token (universal prefill)
        cur = toks[:, :1]
        for t in range(S + gen.max_new_tokens - 1):
            nxt, cache = self._step(self.params, cache, cur, sampler)
            if t + 1 < S:
                cur = toks[:, t + 1:t + 2]      # teacher-force the prompt
            else:
                cur = nxt
                out.append(nxt)
        self.cache = cache
        return torch.cat(out, dim=1).cpu().numpy()


@dataclasses.dataclass
class Request:
    """One request: its prompt, token budget, result and host times."""
    uid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    result: Optional[np.ndarray] = None
    submitted_at: float = 0.0
    done_at: float = 0.0


class BatchServer:
    """Wave-scheduling batch server.

    Pending requests are grouped into waves of ``batch_size``; each wave is
    left-padded and generated together.  As in the JAX package, each
    wave's context length (``S + max_new_tokens``) is bucketed up to the
    next power of two and the batch is padded to the full ``batch_size``
    with dummy slots, so every wave of a bucket runs the same shapes.  The
    left padding is fed as real tokens (id 0) under one shared position.
    ``generator`` runs the waves.
    """

    def __init__(self, cfg: ModelConfig, params, batch_size: int = 8,
                 gen: GenConfig = GenConfig()):
        self.cfg, self.params = cfg, params
        self.batch_size = batch_size
        self.gen = gen
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._uid = 0
        self.generator = Generator(cfg, params, gen)

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        """Queue a request; returns its uid."""
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                  max_new_tokens, submitted_at=time.time()))
        return self._uid

    def step(self) -> List[int]:
        """Serve one wave; returns finished uids."""
        if not self.queue:
            return []
        wave = self.queue[:self.batch_size]
        self.queue = self.queue[self.batch_size:]
        S = max(len(r.prompt) for r in wave)
        mx = max(r.max_new_tokens for r in wave)
        ctx = 1 << max(1, (S + mx - 1).bit_length())
        Sb = ctx - mx
        toks = np.zeros((self.batch_size, Sb), np.int32)
        for i, r in enumerate(wave):
            toks[i, Sb - len(r.prompt):] = r.prompt     # left padding
        out = self.generator.generate(toks, max_new=mx)
        finished = []
        for i, r in enumerate(wave):
            r.result = out[i, Sb:Sb + r.max_new_tokens]
            r.done_at = time.time()
            self.done[r.uid] = r
            finished.append(r.uid)
        return finished

    def run_until_drained(self) -> Dict[int, Request]:
        """Serve waves until the queue is empty; returns every finished
        request by uid."""
        while self.queue:
            self.step()
        return self.done
