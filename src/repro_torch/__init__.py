"""repro_torch — the PyTorch/CUDA port of the StencilPy reproduction.

A second package beside the JAX reference ``repro``: the same DSL
(``repro_torch.core.dsl``), IR, analysis and fused time-loop engine on
PyTorch tensors, with the Pallas TPU kernels replaced by CUDA C++ kernels
written by hand for Hopper (``repro_torch.kernels.stencil``).  It imports
neither JAX nor ``repro``.
"""
