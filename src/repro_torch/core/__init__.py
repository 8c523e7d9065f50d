"""repro_torch.core — StencilPy on PyTorch.

``from repro_torch.core import dsl as st`` gives the user-facing DSL;
submodules: frontend (parser), ir, analysis, lowering (the plain torch
backend), timeloop (fused time-stepping engine), suite (paper Table 4
kernel suite), acoustic (acoustic ISO), regions (PML decomposition).
"""
from . import analysis, dsl, frontend, ir, lowering, suite, timeloop  # noqa: F401
