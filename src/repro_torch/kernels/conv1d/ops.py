"""Entry points of K6: the causal depthwise conv1d on any device, and its
gradient (``CausalConv1dFn``)."""
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


def weight_grad(x: torch.Tensor, g: torch.Tensor, cw: int) -> torch.Tensor:
    """dw[k, c] = Σ_{b,t} g[b, t, c] · x[b, t − cw + 1 + k, c] (x = 0 below
    t = 0), a reduction in f32 (f64 for f64 inputs), returned in it."""
    T = x.shape[1]
    acc = torch.promote_types(x.dtype, torch.float32)
    x32, g32 = x.to(acc), g.to(acc)
    rows = []
    for k in range(cw):
        s = cw - 1 - k                      # rows tap k looks back
        rows.append((g32[:, s:] * x32[:, :T - s]).sum(dim=(0, 1)))
    return torch.stack(rows)


class CausalConv1dFn(torch.autograd.Function):
    """``causal_conv1d`` with its gradient.  Forward: K6 (the kernel on the
    card, the plain version on the CPU).  Backward: ``dx`` is the
    anti-causal conv with the same taps, K6 itself on the time-reversed
    cotangent, ``flip_t(K6(flip_t(g), w))`` (the two flips are copies);
    ``dw`` is ``weight_grad``, rounded once to ``w``'s dtype.  (The JAX
    package has no backward kernel: its training differentiates the
    jnp conv.)"""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return causal_conv1d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = causal_conv1d(g.flip(1).contiguous(), w).flip(1)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, g, w.shape[0]).to(w.dtype)
        return dx, dw
