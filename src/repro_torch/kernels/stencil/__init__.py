"""Stencil kernels for Hopper: K1 ``fused_step`` and K2 ``stream_step``,
their plan (``codegen.CudaPlan``), point-function emitter and nvcc build step."""
from . import codegen, ops, ref  # noqa: F401
