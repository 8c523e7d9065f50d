"""Carry state across from the JAX package.

For a stencil the "weights" are the grids themselves: the wavefields and the
coefficient grids (``vp2``, ``damp``).  The JAX package holds them as
halo-padded arrays; ``grids_from_numpy`` takes those arrays (converted to
numpy by the caller, e.g. ``np.asarray(g.data)``) and builds the port's
tensors and ``st.grid``s.  The kernel source itself is shared text that
both frontends parse, so the kernels need no conversion.  Nothing here
imports JAX, and the arrays given are copied, never written.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from .core import dsl as st


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
