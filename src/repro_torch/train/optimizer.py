"""Hand-rolled AdamW + global-norm clipping + warmup-cosine schedule (the
JAX package's ``train/optimizer.py``).

The optimizer state is a plain tree shaped like the params (dicts and
lists of tensors), f32.  Unlike the JAX package, ``apply`` updates the
params and the moments in place, leaf by leaf, so a step holds one leaf's
temporaries at a time; it returns the same trees.

A sharded state (leaves ``sharding.ShardedTensor``, the sharded step of
``train_loop.compile_train_step``) inherits the params' sharding: each
shard owns the moments of its parameter block (ZeRO-style).  ``apply``
then counts each distinct block once in the global norm (replicas would
inflate the clip), computes each block's update once, on its primary
copy, with the ``torch._foreach_*`` operators (a mesh of many shards has
many small tensors), and copies it to the block's replicas; weight decay
keys on the whole leaf's rank.

``compress_int8`` / ``decompress_int8``: per-leaf symmetric int8
quantization of a gradient tree (the JAX package's cross-pod all-reduce
compression; neither package wires it into the step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.sharding import ShardedTensor, zeros_like

# bytes of tensors a chunk of the sharded update takes at a time (its
# temporaries are a few times that)
_CHUNK_BYTES = 1 << 28


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
    """Zero first and second moments, f32, beside each param (a sharded
    param: in its blocks)."""
    def zeros(p):
        if isinstance(p, ShardedTensor):
            return zeros_like(p, torch.float32)
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
    empty tree.  A ``ShardedTensor`` leaf counts each distinct block once
    (its primary copy)."""
    if any(isinstance(l, ShardedTensor) for l in tree_leaves(tree)):
        return _sharded_norm(tree_leaves(tree))
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
    if any(isinstance(p, ShardedTensor) for p in tree_leaves(params)):
        return _apply_sharded(c, params, grads, opt_state, step, ndims)
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


# -- the sharded update ---------------------------------------------------------
def _by_device(tensors) -> Dict:
    out: Dict = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.device, []).append(i)
    return out


def _sharded_norm(leaves) -> torch.Tensor:
    """The global norm of sharded leaves, each distinct block once:
    ``torch._foreach_norm`` a device, in f32."""
    ts = [t.float() for l in leaves for t in (
        l.primaries() if isinstance(l, ShardedTensor) else [torch.as_tensor(l)])]
    if not ts:
        return torch.tensor(0.0, dtype=torch.float32)
    dev0 = ts[0].device
    sq = []
    for dev, idx in _by_device(ts).items():
        norms = torch._foreach_norm([ts[i] for i in idx])
        sq.append(torch.stack(norms).square().sum().to(dev0))
    return torch.sqrt(torch.stack(sq).sum())


def _chunks(idx, tensors):
    """``idx`` cut into runs of at most ``_CHUNK_BYTES`` of tensors."""
    run, size = [], 0
    for i in idx:
        run.append(i)
        size += tensors[i].numel() * tensors[i].element_size()
        if size >= _CHUNK_BYTES:
            yield run
            run, size = [], 0
    if run:
        yield run


def _apply_sharded(c: OptConfig, params, grads, opt_state, step, ndims):
    """``apply`` on a sharded state: ``grads`` holds each block's summed
    gradient on its primary copy (``ShardedTensor``s of one copy a block)."""
    if ndims is None:
        ndims = tree_map(lambda p: p.dim(), params)
    gnorm = _sharded_norm(tree_leaves(grads))
    scale = _clip_scale(gnorm, c.clip_norm)
    t = torch.as_tensor(step, dtype=torch.float32) + 1.0
    lr = schedule(c, step)
    bc1 = 1.0 - c.b1 ** t
    bc2 = 1.0 - c.b2 ** t
    lr_f, bc1_f, bc2_f = float(lr), float(bc1), float(bc2)

    ps, gs, ms, vs, decay, leaves = [], [], [], [], [], []

    def collect(p, g, m, v, nd):          # leaves paired by key, not order
        for pb, gb, mb, vb in zip(p.primaries(), g.primaries(), m.primaries(),
                                  v.primaries()):
            ps.append(pb)
            gs.append(gb)
            ms.append(mb)
            vs.append(vb)
            decay.append(bool(c.weight_decay) and nd >= 2)
        leaves.append((p, m, v))
    tree_map(collect, params, grads, opt_state["m"], opt_state["v"], ndims)

    with torch.no_grad():
        for dev, idx in _by_device(ps).items():
            sc = scale.to(dev)
            for run in _chunks(idx, ps):
                p_, m_, v_ = ([ps[i] for i in run], [ms[i] for i in run],
                              [vs[i] for i in run])
                g_ = torch._foreach_mul([gs[i].float() for i in run], sc)
                torch._foreach_mul_(m_, c.b1)
                torch._foreach_add_(m_, torch._foreach_mul(g_, 1 - c.b1))
                torch._foreach_mul_(v_, c.b2)
                torch._foreach_add_(v_, torch._foreach_mul(
                    torch._foreach_mul(g_, 1 - c.b2), g_))
                del g_
                den = torch._foreach_sqrt(torch._foreach_div(v_, bc2_f))
                torch._foreach_add_(den, c.eps)
                u = torch._foreach_div(torch._foreach_div(m_, bc1_f), den)
                del den
                dec = [k for k, i in enumerate(run) if decay[i]]
                if dec:
                    ud = [u[k] for k in dec]
                    torch._foreach_add_(ud, torch._foreach_mul(
                        [p_[k].float() for k in dec], c.weight_decay))
                # p - lr·u in f32, rounded to the param's dtype (in place
                # where that is f32)
                step_ = torch._foreach_mul(u, lr_f)
                del u
                if all(t.dtype == torch.float32 for t in p_):
                    torch._foreach_sub_(p_, step_)
                else:
                    torch._foreach_copy_(p_, torch._foreach_sub(
                        [t.float() for t in p_], step_))
                del step_
        # replicas take their block's new values
        for leaf in leaves:
            for t_ in leaf:
                t_.sync_replicas()
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


# -- gradient compression (cheap cross-pod all-reduce) ----------------------------
def compress_int8(tree):
    """Per-leaf symmetric int8 quantization: ``{"q": int8, "scale": f32}``
    for each leaf, ``scale = max(max|g|, 1e-12) / 127`` and ``q =
    clip(round(g / scale), -127, 127)`` (round half to even, as
    ``jnp.round``).  Shrinks a cross-pod gradient all-reduce 4x against
    f32."""
    def one(g):
        g32 = torch.as_tensor(g).float()
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}
    return tree_map(one, tree)


def decompress_int8(ctree):
    """The f32 tree ``q * scale`` of ``compress_int8``'s output."""
    if isinstance(ctree, dict) and set(ctree) == {"q", "scale"} \
            and torch.is_tensor(ctree["q"]):
        return ctree["q"].float() * ctree["scale"]
    if isinstance(ctree, dict):
        return {k: decompress_int8(v) for k, v in ctree.items()}
    if isinstance(ctree, (list, tuple)):
        return [decompress_int8(v) for v in ctree]
    raise TypeError(f"decompress_int8: unexpected leaf {type(ctree).__name__}")
