"""Entry point of K6: the causal depthwise conv1d on any device."""
from __future__ import annotations

import torch

from .conv1d import causal_conv1d_cuda, check_args
from .ref import causal_conv1d_ref


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B, T, W]; w: [cw, W] → causal depthwise conv, same length (zero
    history).  CUDA tensors launch the kernel (or raise); CPU tensors run
    the plain version."""
    check_args(x, w)
    if x.device.type == "cuda":
        return causal_conv1d_cuda(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"causal_conv1d: unsupported device {x.device}")
    return causal_conv1d_ref(x, w)
