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

``compile_serve_step`` is the step over a mesh (the JAX package's serve
step jitted with ``param_shardings`` and ``cache_shardings``): each data
group decodes its rows on its model shards (``models/sharded.py``), its
cache read through views of the cache's shards and written in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import op_analysis
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import sharded as _sharded


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
    the logits of the last position instead of tokens (f32; f64 in an
    f64 run)."""
    temperature = max(float(temperature), 1e-6)

    def serve_step(params, cache, tokens, generator=None):
        logits, cache2 = api.decode_step(cfg, params, cache, tokens)
        return _next(L.wide(logits[:, -1]), sample, temperature,
                     generator), cache2

    return serve_step


def _next(logits, sample: bool, temperature: float, generator):
    """The logits ``[B, V]`` (``sample=False``; f32, f64 in an f64 run),
    or the next tokens ``[B, 1]`` int32: greedy without a generator, else
    one draw a row from it, rows in order."""
    if not sample:
        return logits
    if generator is None:
        nxt = torch.argmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return nxt[:, None].to(torch.int32)


@dataclasses.dataclass
class ServePlan:
    """What the sharded serve step was built for: the mesh, the params',
    the cache's and the tokens' shardings, the KV cache's split
    (``"heads"``, ``"seq"`` or None), the number of data groups, and the
    bytes of params, cache and tokens each shard holds."""
    mesh: object
    param_shardings: object
    cache_shardings: object
    token_sharding: sharding.NamedSharding
    kv_mode: Optional[str]
    n_groups: int
    param_bytes_per_shard: int
    cache_bytes_per_shard: int
    token_bytes_per_shard: int


def _cache_pairs(cache, new):
    """(leaf, new value) of every ``ShardedTensor`` of ``cache`` beside
    the tree ``new`` of the same structure."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            yield from _cache_pairs(v, new[k])
    elif isinstance(cache, (list, tuple)):
        for a, b in zip(cache, new):
            yield from _cache_pairs(a, b)
    elif isinstance(cache, sharding.ShardedTensor):
        yield cache, new


def compile_serve_step(cfg: ModelConfig, mesh, cache_spec, sample: bool = True,
                       temperature: float = 1.0,
                       use_kernel_conv: Optional[bool] = None):
    """The single-token step over ``mesh``: → ``(plan, step)``.
    ``step(params, cache, tokens [B, 1], generator=None) -> (next_tokens
    [B, 1] int32 or, with ``sample=False``, the logits [B, V];
    cache')`` takes the params placed by ``state_shardings`` (or
    ``sharding.param_shardings``) and a cache placed by
    ``plan.cache_shardings`` (``cache_spec``: a cache of the same shapes,
    e.g. the one to be placed).  The cache
    is donated: its shards are written in place and ``cache'`` holds the
    same ``ShardedTensor``s with the new position.  The rows go one data
    group at a time; the logits are gathered over the vocab and stacked
    in global row order, so that greedy decoding gives the unsharded
    step's tokens and a generator draws once a row in that order, as
    ``make_serve_step`` does.  ``use_kernel_conv`` as in
    ``griffin.causal_conv`` (K6 once a model shard)."""
    groups = _sharded.groups(mesh)
    pshapes = api.init_params(cfg, device="meta")
    with sharding.use_activation_mesh(mesh):
        kv_mode = sharding.kv_cache_mode(cfg)
    pshard = sharding.param_shardings(cfg, mesh, pshapes)
    cshard = sharding.cache_shardings(cfg, mesh, cache_spec)
    B = next(leaf.shape[0] for leaf in _leaves(cache_spec) if hasattr(leaf, "shape"))
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    tshard = sharding.NamedSharding(mesh, sharding.resolve(("batch", None), (B, 1), mesh))
    plan = ServePlan(mesh=mesh, param_shardings=pshard, cache_shardings=cshard,
                     token_sharding=tshard, kv_mode=kv_mode, n_groups=len(groups),
                     param_bytes_per_shard=sharding.shard_bytes(pshapes, pshard),
                     cache_bytes_per_shard=sharding.shard_bytes(cache_spec, cshard),
                     token_bytes_per_shard=sharding.shard_bytes(tokens, tshard))
    temperature = max(float(temperature), 1e-6)
    kw = {} if use_kernel_conv is None else {"use_kernel_conv": use_kernel_conv}

    def step(params, cache, tokens, generator=None):
        tokens = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                                 else tokens)
        B = tokens.shape[0]
        dev0 = groups[0].first
        if B % len(groups) == 0:
            b = B // len(groups)
            loop = op_analysis.trips(enumerate(groups))    # an account may sample it
            repeat = 1
        else:
            # a batch that does not split over the data groups is replicated
            # over them (``resolve`` leaves it whole, as the cache's rows):
            # the first group decodes every row, its new cache state is
            # copied to the replicas, and an account charges its pass to
            # every group, as each decodes the rows on a mesh
            b, loop, repeat = B, op_analysis.trips(enumerate(groups[:1])), len(groups)
        rows, pos = [], None
        with torch.no_grad(), sharding.use_activation_mesh(mesh), \
                op_analysis.repeated(repeat):
            for gi, g in loop:
                view = _tree_map(g.view, params)
                local = _tree_map(g.local_view, cache)
                with sharding.use_group(g):
                    logits, new = api.decode_step(
                        cfg, view, local, tokens[gi * b:(gi + 1) * b].to(g.first), **kw)
                    logits = logits[:, -1]
                    if isinstance(logits, _sharded.Sharded):
                        logits = g.relayout(logits, None).parts[0]
                for leaf, value in _cache_pairs(cache, new):
                    g.write_back(leaf, value)
                pos = new["pos"]
                rows.append(L.wide(logits).to(dev0))
            if repeat > 1:
                for leaf, _ in _cache_pairs(cache, cache):
                    leaf.sync_replicas()
        out = _next(torch.cat(loop.fill(rows)), sample, temperature, generator)
        return out, {**cache, "pos": pos}

    return plan, step


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree):
    """``fn`` on each ``ShardedTensor`` of ``tree``; other leaves kept."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, sharding.ShardedTensor) else tree


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
