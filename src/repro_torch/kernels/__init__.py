"""Hand-written Hopper kernels of the port (CUDA C++ under ``*/csrc``):
``stencil`` (K1–K5), ``conv1d`` (K6) and ``decode_attn`` (K7), built by
``_build``."""
