"""Plain PyTorch version of K6, the causal depthwise conv1d."""
from __future__ import annotations

import torch


def causal_conv1d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B, T, W]; w: [cw, W] → y_t = Σ_k w[k] · x_{t-cw+1+k} (zero
    history), same shape and dtype as ``x``.

    Products and sums in f32 (f64 for f64 inputs), in tap order, rounded
    once to ``x.dtype``, as the kernel computes them.  (The JAX package's
    oracle adds in the input dtype, so in bf16 the two differ by its
    roundings.)  Counts its calls in ``causal_conv1d_ref.calls``."""
    causal_conv1d_ref.calls += 1
    cw, T = w.shape[0], x.shape[1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = torch.nn.functional.pad(x.to(acc), (0, 0, cw - 1, 0))
    w32 = w.to(acc)
    return sum(xp[:, k:k + T] * w32[k] for k in range(cw)).to(x.dtype)


causal_conv1d_ref.calls = 0
