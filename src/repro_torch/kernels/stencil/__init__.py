"""Stencil kernels for Hopper: K1 ``fused_step``, K2 ``stream_step``, K3
``temporal_step``, K4 ``map_step`` and K5 ``semi_step``, their plans
(``codegen.CudaPlan``, ``codegen.MapPlan``), point-function emitter; the nvcc
build step is ``repro_torch.kernels._build``."""
from . import codegen, ops, ref  # noqa: F401
