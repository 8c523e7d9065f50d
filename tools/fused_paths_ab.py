"""Time the fused main paths of several source trees side by side on the card.

Each tree given runs, in a fresh process of its own, what ``chip_smoke.py``
phases 3 and 4 time for the fused path: star3d4r and acoustic ISO at
512^3 f32 under K1 (gmem), K2 (shift), K3 (shift, ``time_block=2``) and
K5 (semi); each kernel's launch on random fields with CUDA events, and
each main path, 100 steps of ``st.timeloop`` (acoustic: ``fuse_steps=10``
and its source in ``between``), ``--runs`` times.  Written to compare a
change of the kernels' sources with its parent: give the trees (each a
``src`` directory's parent, e.g. ``git archive`` of a commit unpacked
under ``build/``) in the order A, B, B, A.

    python3 tools/fused_paths_ab.py --trees A B B A [--runs 3] [--json PATH]

Needs a CUDA card; prints the card's name and power limit, one line per
tree, kernel and path, and the whole record as JSON on its last line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (512, 512, 512)
STEPS, FUSE, PML_WIDTH, REPS = 100, 10, 10, 30
KERNELS = {"fused_step": ("gmem", 1), "stream_step": ("shift", 1),
           "temporal_step": ("shift", 2), "semi_step": ("semi", 1)}


def worker(tree: pathlib.Path, runs: int) -> dict:
    """Kernel times and main paths of both workloads with ``tree``'s
    package."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.core import acoustic, suite
    from repro_torch.core import dsl as st
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil import codegen
    from repro_torch.kernels.stencil.fused_step import fused_step
    from repro_torch.kernels.stencil.semi_step import semi_step
    from repro_torch.kernels.stencil.stream_step import stream_step
    from repro_torch.kernels.stencil.temporal_step import temporal_step
    wrappers = {"fused_step": fused_step, "stream_step": stream_step,
                "temporal_step": temporal_step, "semi_step": semi_step}
    mods = {"st": st, "suite": suite, "acoustic": acoustic}
    workloads = [cs.Workload("star3d4r", mods), cs.Workload("acoustic_iso", mods)]
    t0 = time.perf_counter()
    _build.build_many([w.plan(codegen, SHAPE, t, k).source()
                       for w in workloads for t, k in KERNELS.values()])
    out = {"build_s": time.perf_counter() - t0, "kernels": {}, "paths": {}}
    for w in workloads:
        for kname, (template, k) in KERNELS.items():
            plan = w.plan(codegen, SHAPE, template, k)
            kern = wrappers[kname]
            padded = plan.to_padded(w.arrays(torch, SHAPE, seed=1))
            if kname == "temporal_step":
                spares = plan.make_spares(padded)
                launch = lambda: kern(plan, padded, spares, w.scalars)  # noqa: E731
            else:
                launch = lambda: kern(plan, padded, w.scalars)  # noqa: E731
            out["kernels"][f"{kname}[{w.name}]"] = cs.time_ms(torch, launch, REPS, 3) / k
            del padded
            torch.cuda.empty_cache()
    for w in workloads:
        for kname, (template, k) in KERNELS.items():
            be = st.hopper(template=template, time_block=k)
            rates = []
            for _ in range(runs):
                if w.name == "star3d4r":
                    g = suite.make_grids("star3d4r", SHAPE, seed=0)
                    res = st.launch(backend=be)(lambda u, v: st.timeloop(
                        STEPS, swap=("v", "u"))(w.kernel)(u, v))(g["u"], g["v"]).value
                else:
                    p0, p1, vp2, damp, dt = acoustic.make_fields(SHAPE, pml_width=PML_WIDTH)
                    acoustic.inject_source(p1, 0)

                    def between(t, grids):
                        acoustic.inject_source(grids["p1"], t)
                    res = st.launch(backend=be, fuse_steps=FUSE)(
                        acoustic.acoustic_target_fused)(p0, p1, vp2, damp, dt, STEPS,
                                                        between=between).value
                rates.append(STEPS / res.seconds)
                torch.cuda.empty_cache()
            out["paths"][f"{kname}[{w.name}]"] = {"steps_per_s": rates,
                                                  "median": statistics.median(rates)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=pathlib.Path)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds a tree's run may take")
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker.resolve(), args.runs)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    record = {"card": smi, "shape": list(SHAPE), "runs": []}
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree), "--runs", str(args.runs)],
            capture_output=True, text=True, timeout=args.timeout)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        record["runs"].append({"tree": str(tree), **run})
        print(f"{tree}: build {run['build_s']:.1f} s", flush=True)
        for key, ms in run["kernels"].items():
            path = run["paths"][key]
            print(f"{tree} {key}: kernel {ms:.4f} ms/step; main path "
                  f"{path['median']:.1f} steps/s (runs "
                  f"{', '.join(f'{r:.1f}' for r in path['steps_per_s'])})", flush=True)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
