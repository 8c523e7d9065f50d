"""Training step: microbatched gradient accumulation + AdamW (the JAX
package's ``train/train_loop.py``).

``make_train_step(cfg, tc)`` returns ``train_step(state, batch) ->
(state, metrics)`` on one device.  The state is ``{"params", "opt": {"m",
"v"}, "step"}``: the params f32 (one dict per layer, as
``api.init_params`` gives them), the moments f32 beside them, ``step`` an
int.  Microbatching runs ``n_microbatches`` slices of the global batch
one after the other, accumulating f32 gradients; the activation peak is
one microbatch.  The step updates the state in place
(``optimizer.apply``) and returns it.

``compile_train_step(cfg, tc, mesh, batch_specs)`` is the sharded step
over a mesh (``launch/mesh.py``): the state placed by
``state_shardings`` (params 2-D sharded, FSDP over 'data' x TP over
'model', the moments beside them, ``step`` replicated), the batch split
over ('pod', 'data').  Each microbatch runs its data groups one after
another (``models/sharded.py``): a group's forward and backward over its
model shards, its gradients added into the shards'.  Then each distinct
block's gradient (summed over its replicas) goes through AdamW once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import sharded as _sharded

from . import optimizer
from .optimizer import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: optimizer.OptConfig = dataclasses.field(
        default_factory=optimizer.OptConfig)
    n_microbatches: int = 1


def init_state(cfg: ModelConfig, *, device=None, seed: int = 0) -> Dict:
    """Random params on ``device`` (None: the card) from a
    ``torch.Generator`` seeded with ``seed``, zero moments, step 0."""
    params = api.init_params(cfg, device=device, seed=seed)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def state_specs(cfg: ModelConfig) -> Dict:
    """The state's shapes and dtypes, allocating nothing: params and
    moments on the ``meta`` device, ``step`` 0."""
    pshapes = api.init_params(cfg, device="meta")
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    return {"params": pshapes,
            "opt": {"m": tree_map(f32, pshapes), "v": tree_map(f32, pshapes)},
            "step": 0}


def state_shardings(cfg: ModelConfig, mesh) -> Dict:
    """The parameters' ``NamedSharding``s, the same again for ``m`` and
    ``v``, and a replicated one for ``step``."""
    ps = sharding.param_shardings(cfg, mesh, api.init_params(cfg, device="meta"))
    return {"params": ps,
            "opt": {"m": tree_map(lambda s: s, ps), "v": tree_map(lambda s: s, ps)},
            "step": sharding.scalar_sharding(mesh)}


def init_sharded_state(cfg: ModelConfig, mesh, *, device=None,
                       seed: int = 0) -> Dict:
    """``init_state``'s draws (params from ``api.init_params`` on ``device``,
    None: the mesh's first device) placed on ``mesh`` leaf by leaf, each
    whole leaf freed once its shards exist; the moments made in their
    blocks."""
    dev = mesh.devices.flat[0] if device is None else device
    shard = state_shardings(cfg, mesh)
    params = api.init_params(cfg, device=dev, seed=seed)
    params = sharding.device_put(params, shard["params"], donate=True)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


@dataclasses.dataclass
class TrainPlan:
    """What the sharded step was built for: its in and out shardings, the
    bytes of state and of batch each shard holds, and the bytes each
    device holds (its shards' blocks, one copy a device)."""
    mesh: object
    in_shardings: tuple
    out_shardings: tuple
    n_groups: int
    n_microbatches: int
    state_bytes_per_shard: int
    batch_bytes_per_shard: int
    state_bytes_per_device: Dict


def _bytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()


def _plan(cfg, tc, mesh, st_shard, b_shard, metrics_shard, batch_specs):
    specs = state_specs(cfg)
    leaves = [(l, s) for part in ("params", "opt")
              for l, s in zip(tree_leaves(specs[part]), tree_leaves(st_shard[part]))]
    per_shard = sum(_bytes(s.shard_shape(l.shape), l.dtype) for l, s in leaves)
    per_device: Dict = {}
    for l, s in leaves:
        held = set()
        for pos in np.ndindex(*mesh.devices.shape):
            key = (mesh.devices[pos], s.block_of(l.shape, pos))
            if key not in held:
                held.add(key)
                per_device[key[0]] = per_device.get(key[0], 0) + _bytes(
                    s.shard_shape(l.shape), l.dtype)
    b_leaves = [(l, s) for l, s in zip(tree_leaves(batch_specs),
                                       tree_leaves(b_shard))
                if hasattr(l, "shape")]
    batch = sum(_bytes(s.shard_shape(tuple(l.shape)), _dtype_of(l))
                for l, s in b_leaves)
    return TrainPlan(mesh=mesh, in_shardings=(st_shard, b_shard),
                     out_shardings=(st_shard, metrics_shard),
                     n_groups=len(_sharded.groups(mesh)),
                     n_microbatches=tc.n_microbatches,
                     state_bytes_per_shard=per_shard,
                     batch_bytes_per_shard=batch,
                     state_bytes_per_device=per_device)


def _dtype_of(leaf) -> torch.dtype:
    if torch.is_tensor(leaf):
        return leaf.dtype
    return torch.from_numpy(np.zeros((), dtype=np.asarray(leaf).dtype)).dtype


def compile_train_step(cfg: ModelConfig, tc: TrainConfig, mesh, batch_specs,
                       donate: bool = True, use_kernel_conv: Optional[bool] = None):
    """The sharded train step over ``mesh``: → ``(plan, step)``.  ``plan``
    is a ``TrainPlan`` (shardings and bytes a shard); ``step(state,
    batch) -> (state, metrics)`` takes a state placed by
    ``state_shardings`` (``sharding.device_put`` or
    ``init_sharded_state``) and a global batch (numpy arrays or tensors,
    its leading dimension split over the data groups), and advances the
    state in place (``donate=False``: a copy).  ``batch_specs``: the
    batch's leaves' shapes and dtypes (``configs.shapes.input_specs`` or
    the arrays).  ``use_kernel_conv`` as in ``griffin.causal_conv``.
    MoE, VLM, xLSTM and encoder-decoder configs raise ``not_ported``
    (ROADMAP.md item 9b)."""
    _sharded.check_family(cfg)
    st_shard = state_shardings(cfg, mesh)
    b_shard = sharding.batch_shardings(cfg, mesh, batch_specs)
    scalar = sharding.scalar_sharding(mesh)
    metrics_shard = {"loss": scalar, "grad_norm": scalar, "lr": scalar}
    plan = _plan(cfg, tc, mesh, st_shard, b_shard, metrics_shard, batch_specs)
    grad_fn = make_sharded_loss_and_grad(cfg, mesh, tc.n_microbatches,
                                         use_kernel_conv)

    def step(state, batch):
        if not donate:
            state = {"params": tree_map(lambda l: l.map(torch.clone), state["params"]),
                     "opt": tree_map(lambda l: l.map(torch.clone), state["opt"]),
                     "step": state["step"]}
        params = state["params"]
        loss, grads = grad_fn(params, batch)
        new_params, new_opt, om = optimizer.apply(
            tc.opt, params, grads, state["opt"], state["step"],
            ndims=api.stacked_ndims(cfg, params))
        del grads
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **om}

    return plan, step


def make_sharded_loss_and_grad(cfg: ModelConfig, mesh, n_microbatches: int = 1,
                               use_kernel_conv: Optional[bool] = None):
    """``loss_and_grad(params, batch) -> (loss, grads)`` over ``mesh``:
    ``params`` placed by ``state_shardings``, ``batch`` the global batch;
    the loss (f32, on the first group's first device) the mean over the
    microbatches' data groups, as ``make_train_step``'s; ``grads`` a tree
    of ``ShardedTensor``s, each block's gradient summed over its replicas
    onto its primary copy."""
    _sharded.check_family(cfg)
    groups = _sharded.groups(mesh)
    n_mb, n_g = n_microbatches, len(groups)

    def group_step(params, batch, g, weight):
        """One group's loss, its gradient (times ``weight``) added into the
        shards'.  The backward pass runs under the group too: it recomputes
        checkpointed layers."""
        view = tree_map(g.view, params)
        with sharding.use_activation_mesh(mesh), sharding.use_group(g):
            loss, _ = api.loss_fn(cfg, view, batch, use_kernel_conv=use_kernel_conv)
            if isinstance(loss, _sharded.Sharded):
                loss = loss.parts[0]
            (loss * weight).backward()
        return loss.detach()

    def loss_and_grad(params, batch):
        batch = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
                 for k, v in batch.items()}
        B = next(iter(batch.values())).shape[0]
        if B % (n_mb * n_g):
            raise ValueError(f"global batch {B} does not split into {n_mb} "
                             f"microbatches of {n_g} data groups")
        b = B // (n_mb * n_g)
        held = [t for leaf in tree_leaves(params) for t in leaf.local_tensors()]
        dev0 = groups[0].first
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev0)
        try:
            for t in held:
                t.grad = None
                t.requires_grad_(True)
            for i in range(n_mb):
                for gi, g in enumerate(groups):
                    lo = i * (B // n_mb) + gi * b
                    gb = {k: v[lo:lo + b].to(g.first) for k, v in batch.items()}
                    loss = group_step(params, gb, g, 1.0 / (n_mb * n_g))
                    loss_sum = loss_sum + loss.float().to(dev0)
        finally:
            for t in held:
                t.requires_grad_(False)
        grads = tree_map(_summed_grad, params)
        for t in held:
            t.grad = None
        return loss_sum / (n_mb * n_g), grads

    return loss_and_grad


def _summed_grad(leaf: sharding.ShardedTensor) -> sharding.ShardedTensor:
    """A leaf's gradient in its slabs (zeros where no group used a slab),
    each block's primary copy holding the block's gradient summed over its
    replicas."""
    slabs = {d: t.grad if t.grad is not None else torch.zeros_like(t)
             for d, t in leaf.slabs.items()}
    g = sharding.ShardedTensor(leaf.sharding, leaf.shape, None, slabs, leaf.rows)
    for copies in g.replicas():
        for r in copies[1:]:
            copies[0].add_(r.to(copies[0].device))
    return g


def _split_microbatches(batch: Dict, n: int) -> Dict:
    def resh(x):
        B = x.shape[0]
        assert B % n == 0, (B, n)
        return x.reshape(n, B // n, *x.shape[1:])
    return {k: resh(v) for k, v in batch.items()}


def _to_device(batch: Dict, device) -> Dict:
    """The batch's arrays as tensors on ``device`` (numpy arrays copied)."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               device=device) for k, v in batch.items()}


def make_loss_and_grad(cfg: ModelConfig,
                       use_kernel_conv: Optional[bool] = None):
    """``loss_and_grad(params, batch) -> (loss, grads)``: the loss of
    ``api.loss_fn`` (detached) and its gradient, a tree like ``params``.
    ``use_kernel_conv`` as in ``griffin.causal_conv`` (False: K6's plain
    version, for checks)."""
    def loss_and_grad(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, _ = api.loss_fn(cfg, live, batch, use_kernel_conv=use_kernel_conv)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)
    return loss_and_grad


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    use_kernel_conv: Optional[bool] = None):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    numpy arrays or tensors (moved to the params' device)."""
    grad_fn = make_loss_and_grad(cfg, use_kernel_conv)

    def train_step(state, batch):
        params = state["params"]
        device = tree_leaves(params)[0].device
        batch = _to_device(batch, device)
        n = tc.n_microbatches
        if n > 1:
            mbs = _split_microbatches(batch, n)
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(n):
                loss, g = grad_fn(params, {k: v[i] for k, v in mbs.items()})
                tree_map(lambda a, b: a.add_(b.float()), gsum, g)
                loss_sum = loss_sum + loss
                del g
            grads = tree_map(lambda g: g / n, gsum)
            loss = loss_sum / n
        else:
            loss, grads = grad_fn(params, batch)

        new_params, new_opt, om = optimizer.apply(
            tc.opt, params, grads, state["opt"], state["step"],
            ndims=api.stacked_ndims(cfg, params))
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss.float(), **om}
        return new_state, metrics

    return train_step
