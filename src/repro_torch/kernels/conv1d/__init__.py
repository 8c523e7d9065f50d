"""K6: causal depthwise conv1d (``ops.causal_conv1d``; with its gradient,
``ops.CausalConv1dFn``), its CUDA kernel (``conv1d.causal_conv1d_cuda``,
``csrc/conv1d.cu``) and plain version (``ref.causal_conv1d_ref``)."""
from . import conv1d, ops, ref  # noqa: F401
