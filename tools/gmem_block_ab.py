"""Time K1's tiles (the one-step gmem build, ``csrc/map_step.cuh`` with
``RT_MAP_T 0``) at 512^3 on the card, side by side.

K1 and K4 gmem share one build: each lane walks ``b0`` planes of a column
with its axis-0 taps in register queues, two points along axis 2, every
tap outside its own cells a load (aligned pairs where the rows allow).
``b0`` amortises the queues' prologue of 2h0 planes; the face ``b1 x b2``
sets the rows a block loads for its axis-1 taps.  This script builds K1
for each block of ``GMEM_BLOCKS_AB`` (or only the default with
``--blocks default``), checks that each agrees with the first (f32: 2e-5
of the magnitude, bf16: one ulp), and times them in turns (in order, then
in reverse, ``--rounds`` times) with CUDA events, for star3d4r and
acoustic in f32 and bf16, with each build's ``ptxas`` registers and
spills.

    PYTHONPATH=src python3 tools/gmem_block_ab.py [--blocks all|default]
        [--src DIR] [--shape 512 512 512] [--rounds 2] [--json PATH]

``--src`` times the port of another checkout (its ``src`` directory, for
example the parent commit's, unpacked under ``build/``) with the same
fields and timer.  Needs a CUDA card; prints the card's
name and power limit, one line per case, and the whole record as JSON on
its last line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
GMEM_BLOCKS_AB = ((16, 4, 64), (32, 4, 64), (64, 4, 64), (16, 8, 64),
                  (16, 16, 64), (16, 2, 128))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", choices=("all", "default"), default="all")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--shape", type=int, nargs=3, default=(512, 512, 512))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import acoustic, suite
    from repro_torch.core import dsl as st
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil import codegen
    from repro_torch.kernels.stencil.fused_step import fused_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"port: {codegen.__file__}", flush=True)
    shape = tuple(args.shape)
    mods = {"st": st, "suite": suite, "acoustic": acoustic}
    workloads = [cs.Workload("star3d4r", mods), cs.Workload("acoustic_iso", mods)]
    blocks = (None,) if args.blocks == "default" else GMEM_BLOCKS_AB

    def plan(w, block):
        halos = {g: (w.halo,) * 3 for g in w.kernel.ir.grid_params}
        return codegen.plan_cuda(w.kernel.ir, halos, shape,
                                 st.hopper(template="gmem", block=block), swap=w.swap)

    dtypes = (torch.float32, torch.bfloat16)
    cases = [(w, d, [plan(w, b) for b in blocks]) for w in workloads for d in dtypes]
    _build.build_many([p.source(d) for w, d, ps in cases for p in ps])

    record = {"card": smi, "shape": list(shape), "src": args.src, "cases": []}
    for w, dtype, plans in cases:
        dname = str(dtype).split(".")[1]
        arrays = w.arrays(torch, shape, seed=2, dtype=dtype)
        runs, outs = [], []
        for p in plans:
            padded = p.to_padded({g: t.clone() for g, t in arrays.items()})
            run = (lambda p=p, padded=padded: fused_step(p, padded, w.scalars))
            run()
            outs.append({g: padded[g].clone() for g in p.out_grids})
            runs.append(run)
        tol = cs.bf16_ulp if dtype == torch.bfloat16 else cs.rel_tol
        errs = [cs.check_out(torch, f"fused_step[{w.name}] {dname} {p.B} vs {plans[0].B}",
                             o, outs[0], tol) for p, o in zip(plans, outs)]
        ms = [[] for _ in plans]
        order = list(range(len(plans)))
        for _ in range(args.rounds):
            for i in order + order[::-1]:
                ms[i].append(cs.time_ms(torch, runs[i], args.reps, 5))
        for p, t, err in zip(plans, ms, errs):
            use = cs.ptxas_usage(_build.ptxas_log(p.source(dtype)))
            row = {"kernel": "fused_step", "workload": w.name, "dtype": dname,
                   "block": list(p.B), "max_abs_diff_vs_first": err,
                   "ms": t, "median_ms": statistics.median(t), **use}
            record["cases"].append(row)
            print(f"fused_step[{w.name}] {dname} block {p.B}: "
                  f"{row['median_ms']:.4f} ms (min {min(t):.4f}, max {max(t):.4f}); "
                  f"ptxas {use['registers']} registers, {use['spill_stores']} B spill "
                  f"stores; |diff| vs {plans[0].B} {err:.3g}", flush=True)
        del arrays, runs, outs
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
