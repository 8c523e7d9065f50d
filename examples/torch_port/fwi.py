"""Full-waveform inversion through the differentiable fused timeloop of the
PyTorch/CUDA port.

Propagate a source through a *guessed* velocity model with the 2-D
acoustic leapfrog

    p_next = 2·p1 − p0 + (vp²·dt²)·Δp1

compare the wavefield against data recorded in the *true* model, and
descend the misfit's gradient — ``torch.autograd.grad`` straight through
``st.differentiable_timeloop`` (the checkpointed O(√T) adjoint,
``core/adjoint.py``) — with the repo's AdamW (``train/optimizer.py``,
which takes a bare velocity tensor as its parameters and never decays
it).  The "observed" data come from the same propagator run on the true
model (an inversion crime, but exactly what validates the adjoint):

    PYTHONPATH=src python examples/torch_port/fwi.py          # full inversion
    PYTHONPATH=src python examples/torch_port/fwi.py --smoke  # tiny + short
    PYTHONPATH=src python examples/torch_port/fwi.py --template gmem
                                # forward and replay on the fused kernel K1
    PYTHONPATH=src python examples/torch_port/fwi.py --smoke --mesh 4
                                # the domain's first axis over 4 shards
    ... --device cpu            # on the CPU (tests, CI)

Full mode asserts the final misfit falls below 10% of the initial misfit;
smoke mode (a few iterations on a tiny grid) asserts it decreases at all.
``--mesh N`` splits the domain's first axis over a mesh of N shards (one
process drives them all) and runs the same forward and adjoint through
the distributed engine, each shard's passes on ``--template``'s kernel
when one is given: gradients reach the sharded velocity model without a
gathered step.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import acoustic, dsl as st
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import optimizer as opt

TEMPLATES = ("gmem", "smem", "f4", "shift", "unroll")
DT = 0.35                                       # CFL-stable for vp ≤ 1.4


@st.kernel
def wave2d(p0: st.grid, p1: st.grid, vp2: st.grid, dt: st.f32):
    lap = (p1.at(-1, 0) + p1.at(1, 0) + p1.at(0, -1) + p1.at(0, 1)
           - 4.0 * p1.at(0, 0))
    p0.at(0, 0).set(2.0 * p1.at(0, 0) - p0.at(0, 0)
                    + vp2.at(0, 0) * dt * dt * lap)


def true_model(n: int) -> np.ndarray:
    """Constant background and a fast inclusion to recover (vp 1.0 → 1.3
    inside), as vp²."""
    vp2 = np.full((n, n), 1.0, np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    vp2[((yy - n // 2) ** 2 + (xx - n // 2) ** 2) < (n // 6) ** 2] = 1.69
    return vp2


def make_between(n: int, device):
    """The Ricker source into the newest buffer (after the swap, "p1"),
    out of place: ``g.data`` is rebound to a new tensor, so autograd
    differentiates through it (the JAX script's ``.at[idx].add``)."""
    src = (2, n // 2)                            # shot near the surface

    def between(t, grids):
        g = grids["p1"]
        idx = tuple(torch.tensor([g.order + s], device=device) for s in src)
        val = torch.full((1,), acoustic.source_wavelet(t, f0=0.06, t0=10),
                         dtype=g.data.dtype, device=device)
        g.data = g.data.index_put(idx, val, accumulate=True)
    return between


def make_problem(n: int, steps: int, device, backend=None, mesh=None,
                 dtype=st.f32):
    """→ (the propagator ``fwd``, the observed data, ``misfit(v)``): the
    misfit of an interior velocity model ``v`` (vp², [n, n]), on grids of
    ``dtype``."""
    shape = (n, n)
    grids = [st.grid(dtype, shape, order=1, device=device) for _ in range(3)]
    grids[2].interior = true_model(n)
    # fuse_steps=1: per-step source cadence; the adjoint thins its
    # checkpoints back to O(√steps) carries (fwd.schedule shows the plan)
    fwd = st.differentiable_timeloop(wave2d, *grids, DT, steps=steps,
                                     swap=("p0", "p1"), fuse_steps=1,
                                     between=make_between(n, device),
                                     backend=backend, mesh=mesh)
    with torch.no_grad():
        observed = fwd()                         # data in the true model
    d_obs = {g: observed[g].detach() for g in ("p0", "p1")}

    def misfit(v):
        arrays = dict(fwd.arrays)
        # out of place, so the gradient reaches v: a copy of the zero-halo
        # grid with v written into its interior
        vp2 = arrays["vp2"].detach().clone()
        vp2[1:-1, 1:-1] = v
        arrays["vp2"] = vp2
        out = fwd(arrays, fwd.scalars)
        return 0.5 * sum(torch.sum((out[g] - d_obs[g]) ** 2)
                         for g in ("p0", "p1"))
    return fwd, d_obs, misfit


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid, few iterations (CI job)")
    ap.add_argument("--n", type=int, default=None, help="interior extent")
    ap.add_argument("--steps", type=int, default=None,
                    help="propagation time steps per shot")
    ap.add_argument("--iters", type=int, default=None,
                    help="optimizer iterations")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--template", default=None, choices=[None, *TEMPLATES],
                    help="run the propagator on st.hopper(template=...) "
                         "(default: st.torch())")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the domain's first axis over N shards and "
                         "run the distributed forward + adjoint")
    args = ap.parse_args(argv)
    device = st.resolve_device(args.device)

    n = args.n or (16 if args.smoke else 48)
    steps = args.steps or (20 if args.smoke else 60)
    iters = args.iters or (8 if args.smoke else 120)
    lr = args.lr or 0.03

    backend = st.hopper(template=args.template) if args.template else st.torch()
    mesh = None
    if args.mesh:
        if n % args.mesh:
            raise SystemExit(f"--mesh {args.mesh} must divide n={n}")
        mesh = mesh_mod.make_mesh(
            (args.mesh,), ("data",),
            devices=None if device.type == "cuda" else [device])
        backend = st.distributed(grid_axes=("data", None), inner=backend)
        print(f"distributed: axis 0 over {args.mesh} shards ({mesh})")

    fwd, _, misfit = make_problem(n, steps, device, backend, mesh)
    print(f"grid {(n, n)}, {steps} steps, schedule: "
          f"stride={fwd.schedule['stride']} "
          f"checkpoints={fwd.schedule['checkpoints']} "
          f"of {len(fwd.schedule['windows'])} windows")

    cfg = opt.OptConfig(lr=lr, warmup_steps=5, total_steps=iters,
                        min_lr_ratio=0.3, weight_decay=0.1, clip_norm=10.0)
    params = torch.full((n, n), 1.0, dtype=torch.float32, device=device)
    state = opt.init(params)                     # start from background

    losses = []
    t0 = time.perf_counter()
    for i in range(iters):
        v = params.detach().requires_grad_(True)
        loss = misfit(v)
        (g,) = torch.autograd.grad(loss, v)
        params, state, metrics = opt.apply(cfg, params, g, state, i)
        losses.append(float(loss.detach()))
        if i % 10 == 0 or i == iters - 1:
            print(f"iter {i:4d}  misfit {losses[-1]:.6e}  "
                  f"({losses[-1] / losses[0]:6.1%} of initial)  "
                  f"|grad| {float(metrics['grad_norm']):.3e}")
    wall = time.perf_counter() - t0
    print(f"{iters} iterations in {wall:.1f}s")

    vp2_true = torch.from_numpy(true_model(n)).to(device)
    model_err0 = float((vp2_true - 1.0).abs().mean())
    model_err = float((vp2_true - params).abs().mean())
    print(f"model error {model_err:.4f} (initial {model_err0:.4f})")

    loss0, loss = losses[0], losses[-1]
    if args.smoke:
        assert loss < loss0, f"misfit did not decrease: {loss0} -> {loss}"
        print(f"OK (smoke): misfit {loss0:.3e} -> {loss:.3e}")
    else:
        assert loss < 0.10 * loss0, \
            f"final misfit {loss:.3e} not < 10% of initial {loss0:.3e}"
        print(f"OK: final misfit {loss / loss0:.1%} of initial")
    return {"losses": losses, "seconds": wall, "final_share": loss / loss0,
            "model_error": model_err, "model_error_initial": model_err0,
            "params": params}


if __name__ == "__main__":
    main()
