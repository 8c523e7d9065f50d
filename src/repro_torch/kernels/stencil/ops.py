"""Array-level entry points of the CUDA stencil kernels.  In place:
``stencil_apply`` writes the output tensors' region and
``stencil_timeloop`` advances the tensors it is given."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import dsl as st


def stencil_apply(kernel: "st.Kernel",
                  arrays: Dict[str, torch.Tensor],
                  scalars: Optional[Mapping[str, float]] = None,
                  *,
                  halos: Optional[Mapping[str, Tuple[int, ...]]] = None,
                  template: str = "gmem",
                  block: Optional[Tuple[int, ...]] = None,
                  mem_type: Optional[str] = None,
                  region=None) -> Dict[str, torch.Tensor]:
    """Apply a ``@st.kernel`` to raw halo-padded tensors (the array-level
    twin of ``st.map`` on the hopper backend): ``arrays`` maps grid-param
    name → tensor of shape interior + 2·halo per axis.  The output tensors'
    interior (or ``region``) is written in place; the dict is returned."""
    from . import codegen

    k_ir = kernel.ir
    if halos is None:
        h = kernel.info.halo
        halos = {g: h for g in k_ir.grid_params}
    g0 = k_ir.grid_params[0]
    interior = tuple(s - 2 * hh for s, hh in zip(arrays[g0].shape, halos[g0]))
    backend = st.hopper(template=template, block=block, mem_type=mem_type)
    plan = codegen.lower_hopper(k_ir, dict(halos), interior, region, backend)
    return plan.apply(dict(arrays), dict(scalars or {}))


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
