"""Hand-written Hopper kernels of the port (CUDA C++ under ``*/csrc``)."""
