"""The steps the JAX package's dry run lowers for its prefill cells
(``launch/dryrun.py``), as steps that run.

``make_prefill_step(cfg)``: ``prefill(params, batch) -> logits [B, 1,
V]``, ``forward_hidden`` then the unembedding of the last position.
``compile_prefill_step(cfg, mesh, batch_specs)`` runs it over a mesh: the
params placed by ``sharding.param_shardings``, the batch split over the
data groups by ``sharding.batch_shardings``, one data group at a time on
its model shards (``models/sharded.py``), the logits returned as a
``ShardedTensor`` laid out ``("batch", None, "vocab")``.  The sharded
decode step is ``serving.serve_loop.compile_serve_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import sharded as _sharded
from repro_torch.train.optimizer import tree_map

__all__ = ["make_prefill_step", "compile_prefill_step", "PrefillPlan"]


def make_prefill_step(cfg: ModelConfig, use_kernel_conv: Optional[bool] = None):
    """→ ``prefill(params, batch) -> logits [B, 1, V]`` of the last
    position (in the compute dtype).  ``use_kernel_conv`` as in
    ``griffin.causal_conv``."""
    def prefill(params, batch):
        hid, _ = api.forward_hidden(cfg, params, batch, use_kernel_conv)
        return L.unembed(params["embed"], hid[:, -1:], cfg)
    return prefill


@dataclasses.dataclass
class PrefillPlan:
    """The sharded prefill step's in and out shardings."""
    mesh: object
    param_shardings: object
    batch_shardings: object
    out_sharding: sharding.NamedSharding


def compile_prefill_step(cfg: ModelConfig, mesh, batch_specs,
                         use_kernel_conv: Optional[bool] = None):
    """``make_prefill_step`` over ``mesh``: → ``(plan, step)``;
    ``step(params, batch) -> logits``, a ``ShardedTensor`` of ``[B, 1, V]``
    under ``plan.out_sharding``.  ``batch``: the global batch (numpy
    arrays or tensors), its rows split over the data groups;
    ``batch_specs`` its leaves' shapes.  K6 runs once a model shard."""
    groups = _sharded.groups(mesh)
    fn = make_prefill_step(cfg, use_kernel_conv)
    B = next(iter(batch_specs.values())).shape[0]
    out = sharding.NamedSharding(mesh, sharding.resolve(
        ("batch", None, "vocab"), (B, 1, cfg.vocab), mesh))
    plan = PrefillPlan(
        mesh=mesh,
        param_shardings=sharding.param_shardings(
            cfg, mesh, api.init_params(cfg, device="meta")),
        batch_shardings=sharding.batch_shardings(cfg, mesh, batch_specs),
        out_sharding=out)

    def step(params, batch):
        batch = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
                 for k, v in batch.items()}
        n = next(iter(batch.values())).shape[0]
        if n % len(groups):
            raise ValueError(f"batch {n} does not split into {len(groups)} "
                             f"data groups")
        b = n // len(groups)
        dev0 = groups[0].first
        rows = []
        with torch.no_grad(), sharding.use_activation_mesh(mesh):
            for gi, g in enumerate(groups):
                gb = {k: v[gi * b:(gi + 1) * b].to(g.first) for k, v in batch.items()}
                with sharding.use_group(g):
                    logits = fn(tree_map(g.view, params), gb)
                    if isinstance(logits, _sharded.Sharded):
                        logits = g.relayout(logits, None).parts[0]
                rows.append(logits.to(dev0))
        return sharding.device_put(torch.cat(rows), out)

    return plan, step
