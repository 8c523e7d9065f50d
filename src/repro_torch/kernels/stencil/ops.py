"""Array-level entry point of the CUDA stencil kernels.  In place:
``stencil_timeloop`` advances the tensors it is given."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import dsl as st


def stencil_timeloop(kernel: "st.Kernel",
                     arrays: Dict[str, torch.Tensor],
                     steps: int,
                     *,
                     swap: Tuple[str, str],
                     scalars: Optional[Mapping[str, float]] = None,
                     halos: Optional[Mapping[str, Tuple[int, ...]]] = None,
                     template: str = "gmem",
                     block: Optional[Tuple[int, ...]] = None,
                     fuse_steps: Optional[int] = None,
                     time_block: int = 1) -> Dict[str, torch.Tensor]:
    """Fused time stepping on raw halo-padded tensors (the array-level twin
    of ``st.timeloop`` on the hopper backend): ``steps`` applications +
    leapfrog rotation of the ``swap`` pair, ``time_block`` steps per launch
    of the temporal-blocking kernel when it is above 1.  Returns the final
    arrays under the name-rotation convention; the tensors are advanced in
    place."""
    from repro_torch.core import timeloop as _tl

    k_ir = kernel.ir
    if halos is None:
        h = kernel.info.halo
        halos = {g: h for g in k_ir.grid_params}
    g0 = k_ir.grid_params[0]
    interior = tuple(s - 2 * hh for s, hh in zip(arrays[g0].shape, halos[g0]))
    backend = st.hopper(template=template, block=block,
                        time_block=time_block)
    return _tl.run_timeloop(k_ir, dict(arrays), dict(scalars or {}), steps,
                            halos=dict(halos), interior_shape=interior,
                            backend=backend, swap=swap,
                            fuse_steps=fuse_steps)
