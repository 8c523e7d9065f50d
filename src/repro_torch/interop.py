"""Carry state across from the JAX package.

For a stencil the "weights" are the grids themselves: the wavefields and the
coefficient grids (``vp2``, ``damp``).  The JAX package holds them as
halo-padded arrays; ``grids_from_numpy`` takes those arrays (converted to
numpy by the caller, e.g. ``np.asarray(g.data)``) and builds the port's
tensors and ``st.grid``s.  The kernel source itself is shared text that
both frontends parse, so the kernels need no conversion.

For a language model, ``params_from_jax``, ``cache_from_jax`` and
``state_from_jax`` take the JAX package's parameter, decode-cache and
train-state trees (leaves converted to numpy by the caller, e.g.
``jax.tree.map(np.asarray, params)``) and unstack them into the port's
one-dict-per-layer lists: the transformer's stacked ``layers`` (and its
cache's stacked ``kv``), Griffin's and xLSTM's ``cycles`` and ``tail``,
the encoder-decoder's ``enc_layers`` and ``dec_layers`` (and its cache's
``kv``, ``xk`` and ``xv``).

Nothing here imports JAX, and the arrays given are copied, never written.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from .configs.base import ModelConfig
from .core import dsl as st
from .models import griffin, xlstm


def grids_from_numpy(arrays: Mapping[str, np.ndarray],
                     halos: Mapping[str, Union[int, Tuple[int, ...]]],
                     device=None) -> Dict[str, "st.grid"]:
    """One ``st.grid`` per array: ``arrays`` map name → full halo-padded
    array, ``halos`` name → halo width (an int, or a per-axis tuple whose
    entries are equal, as ``st.grid`` has one ``order``).  The data are
    copied to ``device`` (None: the card) in the array's dtype."""
    dev = st.resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        h = halos[name]
        hs = (int(h),) * arr.ndim if np.isscalar(h) else tuple(int(x) for x in h)
        if len(set(hs)) != 1:
            raise ValueError(f"grid '{name}': st.grid needs one halo width "
                             f"on every axis, got {hs}")
        shape = tuple(s - 2 * hs[0] for s in arr.shape)
        data = torch.tensor(np.ascontiguousarray(arr), device=dev)
        out[name] = st.grid(dtype=data.dtype, shape=shape, order=hs[0],
                            data=data, device=dev)
    return out


def _tensor(arr, device=None) -> torch.Tensor:
    """A copy of ``arr`` on ``device`` (None: the card) in its dtype;
    bfloat16 arrays (``ml_dtypes``) go through f32, which is exact."""
    arr = np.asarray(arr)
    dev = st.resolve_device(device)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=dev).to(torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(arr), device=dev)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _cycles(tree, cfg: ModelConfig) -> List:
    """One entry per layer from a JAX Griffin or xLSTM tree's ``cycles``
    (each leaf stacked over the ``n_cycles`` full cycles, keyed by pattern
    position) and ``tail``: layer ``c·P + p`` is cycle ``c``, position
    ``p``."""
    mod = griffin if cfg.family == "hybrid" else xlstm
    P = len(mod.pattern_of(cfg))
    n_cycles, tail = mod._cycle_split(cfg)
    layers = [_map(tree["cycles"][str(p)], lambda a, c=c: np.asarray(a)[c])
              for c in range(n_cycles) for p in range(P)]
    layers += [tree["tail"][p] for p in range(tail)]
    return layers


def _stacked(tree) -> List:
    """One entry per index of the leading axis every leaf of ``tree``
    shares (a scanned stack of layers)."""
    first = tree
    while isinstance(first, (dict, list, tuple)):
        first = next(iter(first.values())) if isinstance(first, dict) else first[0]
    return [_map(tree, lambda a, i=i: np.asarray(a)[i])
            for i in range(np.asarray(first).shape[0])]


def params_from_jax(tree, cfg: ModelConfig, device=None):
    """The port's parameters of ``cfg``'s family from the JAX package's
    tree of numpy arrays, on ``device`` (None: the card): the layer stacks
    unstacked into lists, every other entry as it is."""
    conv = lambda a: _tensor(a, device)  # noqa: E731
    if cfg.family in ("hybrid", "ssm"):
        return {"embed": _map(tree["embed"], conv),
                "blocks": [_map(b, conv) for b in _cycles(tree, cfg)],
                "final_norm": _map(tree["final_norm"], conv)}
    stacks = ("enc_layers", "dec_layers") if cfg.family == "audio" \
        else ("layers",)
    return {k: ([_map(b, conv) for b in _stacked(v)] if k in stacks
                else _map(v, conv)) for k, v in tree.items()}


def cache_from_jax(tree, cfg: ModelConfig, device=None):
    """The port's decode cache of ``cfg``'s family from the JAX package's
    cache tree of numpy arrays, on ``device`` (None: the card): Griffin's
    and xLSTM's ``{"blocks", "pos"}``, the transformer's and the
    encoder-decoder's ``{"layers", "pos"}`` (each layer's ``k``/``v``,
    and ``xk``/``xv`` for the encoder-decoder)."""
    conv = lambda a: _tensor(a, device)  # noqa: E731
    pos = int(np.asarray(tree["pos"]))
    if cfg.family in ("hybrid", "ssm"):
        return {"blocks": [_map(b, conv) for b in _cycles(tree, cfg)],
                "pos": pos}
    per_layer = dict(tree["kv"])
    if cfg.family == "audio":
        per_layer.update(xk=tree["xk"], xv=tree["xv"])
    return {"layers": [_map(b, conv) for b in _stacked(per_layer)],
            "pos": pos}


def state_from_jax(tree, cfg: ModelConfig, device=None):
    """The port's train state (``{"params", "opt": {"m", "v"}, "step"}``,
    ``train_loop.init_state``'s layout) from the JAX package's train state
    of numpy arrays, on ``device`` (None: the card)."""
    return {"params": params_from_jax(tree["params"], cfg, device),
            "opt": {k: params_from_jax(tree["opt"][k], cfg, device)
                    for k in ("m", "v")},
            "step": int(np.asarray(tree["step"]))}
