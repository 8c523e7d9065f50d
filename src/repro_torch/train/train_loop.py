"""Training step: microbatched gradient accumulation + AdamW (the JAX
package's ``train/train_loop.py``, on one device).

``make_train_step(cfg, tc)`` returns ``train_step(state, batch) ->
(state, metrics)``.  The state is ``{"params", "opt": {"m", "v"},
"step"}``: the params f32 (one dict per layer, as ``api.init_params``
gives them), the moments f32 beside them, ``step`` an int.  Microbatching
runs ``n_microbatches`` slices of the global batch one after the other,
accumulating f32 gradients; the activation peak is one microbatch.  The
step updates the state in place (``optimizer.apply``) and returns it.

Not ported yet: ``state_shardings`` and ``compile_train_step``, the
sharded AOT step over a device mesh (ROADMAP.md queue 1, item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsl import not_ported
from repro_torch.models import api

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


def state_shardings(cfg: ModelConfig, mesh):
    raise not_ported("train_loop.state_shardings (params and optimizer "
                     "state sharded over a mesh)", "queue 1, item 9")


def compile_train_step(cfg: ModelConfig, tc: TrainConfig, mesh, batch_specs,
                       donate: bool = True):
    raise not_ported("train_loop.compile_train_step (the sharded AOT step)",
                     "queue 1, item 9")


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
