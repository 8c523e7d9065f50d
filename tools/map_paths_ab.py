"""Time K4 f4's and K4 smem's two paths side by side at 512^3 on the card.

f4 loads its tap rows either at places fixed by the plan (pitches that are
multiples of 4 cells, ``MapPlan.f4_org_mod4``) or aligned at run time;
smem stages its tiles either by TMA (``MapPlan.smem_tma``) or by 4-byte
``cp.async`` granules.  At 512^3 the plan picks the first path of each; this
script also builds each kernel with the plan's choice overridden to the
general path, checks that both builds agree, and times them alternately
(specialised, general, general, specialised, ...) with CUDA events, for
star3d4r and acoustic in f32 and bf16, with gmem's build as a yardstick.

    PYTHONPATH=src python3 tools/map_paths_ab.py [--rounds 3] [--json PATH]

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


def general(plan):
    """``plan`` with its f4 load path or smem staging path forced to the
    general one (run-time alignment, 4-byte granules)."""
    plan.f4_org_mod4 = lambda: {g: None for g in plan.opnd_grids}
    tma = plan.smem_tma
    plan.smem_tma = lambda dtype=None: {g: False for g in tma()}
    return plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
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
    from repro_torch.kernels.stencil.map_step import map_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    mods = {"st": st, "suite": suite, "acoustic": acoustic}
    workloads = [cs.Workload("star3d4r", mods), cs.Workload("acoustic_iso", mods)]
    cases = []
    for w in workloads:
        for dtype in (torch.float32, torch.bfloat16):
            for t in ("f4", "smem"):
                cases.append((w, dtype, t, {
                    "specialised": w.map_plan(codegen, SHAPE, t),
                    "general": general(w.map_plan(codegen, SHAPE, t)),
                    "gmem": w.map_plan(codegen, SHAPE, "gmem")}))
    _build.build_many([p.source(d) for _, d, _, ps in cases for p in ps.values()])

    record = {"card": smi, "shape": list(SHAPE), "cases": []}
    for w, dtype, t, plans in cases:
        name = str(dtype).split(".")[1]
        arrays = w.arrays(torch, SHAPE, seed=2, dtype=dtype)
        runs, outs = {}, {}
        for k, plan in plans.items():
            bufs = {g: arrays[g].clone() for g in plan.opnd_grids}
            dst = plan.make_dst(bufs)
            map_step(plan, bufs, w.scalars, dst)
            outs[k] = {g: (bufs if dst is None else dst)[g].clone()
                       for g in plan.out_grids}
            runs[k] = (lambda plan=plan, bufs=bufs, dst=dst:
                       map_step(plan, bufs, w.scalars, dst))
        tol = cs.bf16_ulp if dtype == torch.bfloat16 else cs.rel_tol
        err = cs.check_out(torch, f"{t}[{w.name}] {name} general vs specialised",
                           outs["general"], outs["specialised"], tol)
        ms = {k: [] for k in runs}
        for _ in range(args.rounds):
            for k in ("specialised", "general", "gmem", "gmem", "general",
                      "specialised"):
                ms[k].append(cs.time_ms(torch, runs[k], args.reps, 10))
        row = {"kernel": f"map_step.{t}[{w.name}]", "dtype": name,
               "path_specialised": cs.path_of(plans["specialised"], dtype)["path"],
               "path_general": cs.path_of(plans["general"], dtype)["path"],
               "max_abs_diff": err,
               **{f"{k}_ms": v for k, v in ms.items()},
               **{f"{k}_ptxas": cs.ptxas_usage(_build.ptxas_log(p.source(dtype)))
                  for k, p in plans.items() if k != "gmem"}}
        record["cases"].append(row)
        print(f"{row['kernel']} {name}: specialised "
              f"{statistics.median(ms['specialised']):.4f} ms "
              f"(min {min(ms['specialised']):.4f}, max {max(ms['specialised']):.4f}), "
              f"general {statistics.median(ms['general']):.4f} ms "
              f"(min {min(ms['general']):.4f}, max {max(ms['general']):.4f}), "
              f"gmem {statistics.median(ms['gmem']):.4f} ms; "
              f"|diff| {err:.3g}", flush=True)
        del arrays, runs, outs
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
