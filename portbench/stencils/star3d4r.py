"""Table 4's ``star3d4r`` (25 taps, order 4): its seeded initial state, made
on the device, and its binding to the program's DSL.

State: ``u`` is standard-normal noise in the interior and zero in the
halo; ``v`` is zero (the first step overwrites its interior).  The
leapfrog pair is ``("v", "u")``: each step writes ``v`` from ``u`` and the
names trade buffers.
"""
from __future__ import annotations

from portbench.stencils import Program, full_shape, interior, leapfrog_pairs


def make_state(cfg, gen, device):
    """(tensors, scalars): the full halo'd f32 grids drawn from ``gen``."""
    import torch
    u = torch.zeros(full_shape(cfg), dtype=torch.float32, device=device)
    u[interior(cfg)] = torch.randn(tuple(cfg["shape"]), generator=gen,
                                   dtype=torch.float32, device=device)
    return {"u": u, "v": torch.zeros_like(u)}, {}


def kernel():
    """The program's DSL kernel: its suite's ``star3d4r``."""
    from repro_torch.core import suite
    return suite.get_kernel("star3d4r")


def bind(cfg, tensors, scalars, dtype="f32"):
    """The program's kernel and grids on ``tensors`` (cast to ``dtype``)."""
    from repro_torch.core import dsl as st
    k = kernel()
    grids = {n: st.grid(dtype=getattr(st, dtype), shape=tuple(cfg["shape"]),
                        order=cfg["order"], data=tensors[n])
             for n in k.ir.grid_params}
    return Program(kernel=k, grids=grids, args=[grids[n] for n in k.ir.grid_params],
                   pairs=leapfrog_pairs(cfg["swap"]))
