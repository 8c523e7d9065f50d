"""Acoustic-ISO seismic propagation on the PyTorch/CUDA port (the paper's
§6.2 production workload): 25-point star stencil, 8th order in space, 2nd
in time, PML boundaries, Ricker source — on one device or domain-decomposed
over a mesh.

    PYTHONPATH=src python examples/torch_port/acoustic_iso_3d.py       # torch
    PYTHONPATH=src python examples/torch_port/acoustic_iso_3d.py \\
        --template gmem                     # K4 a step (st.hopper)
    PYTHONPATH=src python examples/torch_port/acoustic_iso_3d.py \\
        --template shift --fuse 10          # fused windows of 10 steps (K2)
    PYTHONPATH=src python examples/torch_port/acoustic_iso_3d.py \\
        --distributed                       # a (4, 2) mesh of shards
    ... --device cpu                        # on the CPU (plain versions)

Without ``--template`` every step runs on ``st.torch()``, the reference.
``--template t`` runs ``st.hopper(template=t)``: one per-application
kernel launch a step (K4 for gmem/smem/f4, K2's and K5's builds for
shift/unroll/semi), or under ``--fuse K`` the fused engine's kernel (K1
for gmem/smem/f4, K2 for shift/unroll, K5 for semi) with the source
injected at window boundaries.  ``--distributed`` decomposes the domain
over a (data=4, model=2) mesh with halo slab copies overlapped with the
interior (``st.distributed(grid_axes=("data", "model", None),
overlap=True)``); one process drives all eight shards, on the card (or the
CPU) given by ``--device``, each shard's passes on ``--template``'s
per-application kernel when one is given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import acoustic, dsl as st
from repro_torch.launch import mesh as mesh_mod

TEMPLATES = ("gmem", "smem", "f4", "shift", "unroll", "semi")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    ap.add_argument("--shape", type=int, nargs=3, default=[48, 48, 48])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pml", type=int, default=8)
    ap.add_argument("--template", default=None, choices=[None, *TEMPLATES])
    ap.add_argument("--fuse", type=int, default=None, metavar="K",
                    help="fused time stepping: K steps a window (source "
                         "injected at window boundaries)")
    ap.add_argument("--distributed", action="store_true")
    args = ap.parse_args(argv)
    device = st.resolve_device(args.device)

    shape = tuple(args.shape)
    inner = st.hopper(template=args.template) if args.template else st.torch()
    if args.distributed:
        # the mesh's shards on the visible cards (repeating one card), or
        # on the CPU
        mesh = mesh_mod.make_mesh(
            (4, 2), ("data", "model"),
            devices=None if device.type == "cuda" else [device])
        backend = st.distributed(grid_axes=("data", "model", None),
                                 overlap=True, inner=inner)
    else:
        mesh, backend = None, inner

    _sync(device)
    t0 = time.perf_counter()
    p, prof = acoustic.run(shape=shape, iters=args.iters, backend=backend,
                           mesh=mesh, pml_width=args.pml,
                           fuse_steps=args.fuse, device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    w = p.interior.double()
    pts = np.prod(shape) * args.iters
    print(f"grid {shape} × {args.iters} steps: {wall:.2f}s "
          f"({pts / wall / 1e6:.1f} Mpoints/s)")
    print(f"profile: {({k: round(v, 3) for k, v in prof.items()})}")
    energy = float((w ** 2).sum())
    max_p = float(w.abs().max())
    print(f"wavefield energy {energy:.4e}, max |p| {max_p:.4e}")
    assert bool(torch.isfinite(w).all())
    # PML sanity: boundary energy should be tiny vs interior energy
    c = args.pml
    inner_e = float((w[c:-c, c:-c, c:-c] ** 2).sum())
    shell = (energy - inner_e) / energy
    print(f"PML shell energy fraction: {shell:.3e}")
    print("OK")
    return {"seconds": wall, "mpoints_per_s": pts / wall / 1e6,
            "profile": dict(prof), "energy": energy, "max_abs_p": max_p,
            "pml_shell_fraction": shell, "field": p.interior}


if __name__ == "__main__":
    main()
