"""Hand-rolled AdamW + global-norm clipping + warmup-cosine schedule (the
JAX package's ``train/optimizer.py``).

The optimizer state is a plain tree shaped like the params (dicts and
lists of tensors), f32.  Unlike the JAX package, ``apply`` updates the
params and the moments in place, leaf by leaf, so a step holds one leaf's
temporaries at a time; it returns the same trees.

Not ported yet: ``compress_int8`` / ``decompress_int8`` (the cross-pod
gradient all-reduce, ROADMAP.md queue 1, item 9).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples of
    tensors) and the matching leaves of ``rest``; a tree of the results
    (lists for lists and tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order (dict insertion order)."""
    out = []
    tree_map(out.append, tree)
    return out


def init(params) -> Dict:
    """Zero first and second moments, f32, beside each param."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def schedule(c: OptConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr; an f32 scalar on
    the CPU."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = c.lr * step / max(c.warmup_steps, 1)
    frac = torch.clamp((step - c.warmup_steps)
                       / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = c.min_lr_ratio * c.lr + (1 - c.min_lr_ratio) * c.lr \
        * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < c.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' f32 sums of squares; 0.0 for an
    empty tree."""
    leaves = [torch.sum(torch.square(torch.as_tensor(l).float()))
              for l in tree_leaves(tree)]
    if not leaves:
        return torch.tensor(0.0, dtype=torch.float32)
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """→ (grads scaled so their global norm is at most ``max_norm``, the
    norm before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def apply(c: OptConfig, params, grads, opt_state, step,
          ndims=None) -> Tuple[Dict, Dict, Dict]:
    """→ (params, opt_state, metrics), both trees updated in place.  step
    is 0-based.

    Weight decay targets matmul weights inside a parameter *tree*: a leaf
    whose rank is at least 2.  The rank is ``ndims``'s leaf where given
    (the rank of the leaf in the JAX package's layout,
    ``api.stacked_ndims``), else the leaf's own.  A bare tensor passed as
    the whole params is a physical field, not a network weight, and is
    never decayed."""
    bare = torch.is_tensor(params)
    grads = tree_map(lambda g: g.float(), grads)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, c.clip_norm)

    t = torch.as_tensor(step, dtype=torch.float32) + 1.0
    lr = schedule(c, step)
    bc1 = 1.0 - c.b1 ** t
    bc2 = 1.0 - c.b2 ** t
    if ndims is None:
        ndims = tree_map(lambda p: p.dim(), params)

    def upd(p, g, m, v, nd):
        g = g * scale
        m.copy_(c.b1 * m + (1 - c.b1) * g)
        v.copy_(c.b2 * v + (1 - c.b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + c.eps)
        if c.weight_decay and not bare and nd >= 2:
            u = u + c.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))

    with torch.no_grad():
        tree_map(upd, params, grads, opt_state["m"], opt_state["v"], ndims)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
