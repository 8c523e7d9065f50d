"""Time K2's and K3's tiles side by side at 512^3 on the card.

K2 (``st.hopper(template="shift")``) takes an 8 x 64 tile by default, three
blocks an SM; a 16 x 64 tile stages fewer cells a point (1.69 against
2.25 at a halo of 4) but holds one block an SM.  K3 (``time_block=2``)
takes the first of ``TEMPORAL_BLOCKS`` whose rings fit, 16 x 64 with
chunks of 128 planes; chunks of 64 re-evaluate twice as many planes of
its first sub-step (2(k-1)h0 a chunk).  This
script builds each alternative, checks that it agrees with the default
(f32: 2e-5 of the magnitude), and times them in turns (default,
alternative, alternative, default, ...) with CUDA events, for star3d4r and
acoustic in f32.

    PYTHONPATH=src python3 tools/stream_tiles_ab.py [--rounds 3] [--json PATH]

Needs a CUDA card; prints the card's name and power limit, one line per
case, and the whole record as JSON on its last line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (512, 512, 512)
# (time_block, default tile, alternative tile)
CASES = [(1, None, (64, 16, 64)), (2, None, (64, 16, 64))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import acoustic, suite
    from repro_torch.core import dsl as st
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil import codegen
    from repro_torch.kernels.stencil.stream_step import stream_step
    from repro_torch.kernels.stencil.temporal_step import temporal_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    mods = {"st": st, "suite": suite, "acoustic": acoustic}
    workloads = [cs.Workload("star3d4r", mods), cs.Workload("acoustic_iso", mods)]

    def plan(w, k, block):
        halos = {g: (w.halo,) * 3 for g in w.kernel.ir.grid_params}
        return codegen.plan_cuda(w.kernel.ir, halos, SHAPE,
                                 st.hopper(template="shift", time_block=k,
                                           block=block), swap=w.swap)

    cases = [(w, k, {"default": plan(w, k, d), "alternative": plan(w, k, a)})
             for w in workloads for k, d, a in CASES]
    _build.build_many([p.source() for _, _, ps in cases for p in ps.values()])

    record = {"card": smi, "shape": list(SHAPE), "cases": []}
    for w, k, plans in cases:
        arrays = w.arrays(torch, SHAPE, seed=2)
        runs, outs = {}, {}
        for name, p in plans.items():
            padded = p.to_padded({g: t.clone() for g, t in arrays.items()})
            if k > 1:
                spares = p.make_spares(padded)
                run = (lambda p=p, padded=padded, spares=spares:
                       temporal_step(p, padded, spares, w.scalars))
                run()
                outs[name] = {g: spares[g].clone() for g in p.step_out_grids}
            else:
                run = (lambda p=p, padded=padded:
                       stream_step(p, padded, w.scalars))
                run()
                outs[name] = {g: padded[g].clone() for g in p.out_grids}
            runs[name] = run
        err = cs.check_out(torch, f"k={k}[{w.name}] alternative vs default",
                           outs["alternative"], outs["default"], cs.rel_tol)
        ms = {name: [] for name in runs}
        for _ in range(args.rounds):
            for name in ("default", "alternative", "alternative", "default"):
                ms[name].append(cs.time_ms(torch, runs[name], args.reps, 5) / k)
        kname = "temporal_step" if k > 1 else "stream_step"
        row = {"kernel": kname, "workload": w.name, "time_block": k,
               "tile_default": list(plans["default"].B),
               "tile_alternative": list(plans["alternative"].B),
               "max_abs_diff": err, **{f"{n}_ms_per_step": v for n, v in ms.items()},
               **{f"{n}_ptxas": cs.ptxas_usage(_build.ptxas_log(p.source()),
                                               f"{kname}_kernel")
                  for n, p in plans.items()}}
        record["cases"].append(row)
        print(f"{row['kernel']}[{w.name}] k={k}: tile {plans['default'].B} "
              f"{statistics.median(ms['default']):.4f} ms/step (min "
              f"{min(ms['default']):.4f}, max {max(ms['default']):.4f}), tile "
              f"{plans['alternative'].B} {statistics.median(ms['alternative']):.4f}"
              f" ms/step (min {min(ms['alternative']):.4f}, max "
              f"{max(ms['alternative']):.4f}); |diff| {err:.3g}", flush=True)
        del arrays, runs, outs
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
