"""Plain-torch oracle for the CUDA stencil kernels: re-exports the torch
lowering (``repro_torch.core.lowering.lower_torch``).  In place:
``reference_apply`` writes the output grids of the arrays it is given."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import ir, lowering


def reference_apply(kernel: ir.StencilIR,
                    halos: Mapping[str, Tuple[int, ...]],
                    interior_shape: Tuple[int, ...],
                    arrays: Dict[str, torch.Tensor],
                    scalars: Optional[Mapping[str, torch.Tensor]] = None,
                    region=None) -> Dict[str, torch.Tensor]:
    """One application of ``kernel``; writes the output grids of
    ``arrays`` in place and returns the dict."""
    fn = lowering.lower_torch(kernel, halos, interior_shape, region)
    return fn(dict(arrays), scalars or {})
