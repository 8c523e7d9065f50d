"""Time cold autotunes of two source trees side by side on the card.

Each tree given runs, in a fresh process of its own, what ``chip_smoke.py``
phase 10 tunes: star3d4r and acoustic ISO at 512^3 f32, a two-stage tune
(``top_k=3``) on a fresh cost model, then an exhaustive one on the same
model.  A tree must hold no built kernel (``build/repro_torch_kernels``),
so every ``nvcc`` build of its tune is cold.  For each tree and workload
it prints the cold two-stage tune's seconds (calibrate, predict, build,
measure), its winner and that winner's time over the exhaustive winner's,
and the rates the model probed.  Written to compare two probe geometries
of the cost model (a crop of the tuned grids, at most 256^3 on the card,
against the grids' own shape): give fresh copies of the two trees in the
order A, B, B, A.

    python3 tools/probe_shape_ab.py --trees A1 B1 B2 A2 [--json PATH]

Needs a CUDA card; prints the card's name and power limit, one line per
tree and workload, and the whole record as JSON on its last line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

SHAPE = (512, 512, 512)
STEPS, TOP_K, PML_WIDTH = 16, 3, 10


def describe(b, fuse) -> str:
    if b.kind == "torch":
        return f"torch f{fuse}"
    tile = "x".join(map(str, b.block)) if b.block else "default"
    return f"{b.template}[{tile}] k{b.time_block} f{fuse}"


def worker(tree: pathlib.Path) -> dict:
    """Both tunes of both workloads with ``tree``'s package."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.core import acoustic, suite
    from repro_torch.core import autotune as at
    from repro_torch.core import cost_model as cm
    from repro_torch.kernels import _build
    if any(_build.BUILD_DIR.glob("*.so")):
        raise SystemExit(f"{_build.BUILD_DIR} holds built kernels: give a "
                         "fresh tree")
    cdir = str(tree / "build" / "autotune_ab")
    out = {}
    for name in ("star3d4r", "acoustic_iso"):
        if name == "star3d4r":
            k, swap = suite.get_kernel(name), ("v", "u")
            fields = suite.make_grids(name, SHAPE, seed=0)
        else:
            k, swap = acoustic.acoustic_iso_kernel, ("p0", "p1")
            p0, p1, vp2, damp, dt = acoustic.make_fields(SHAPE,
                                                         pml_width=PML_WIDTH)
            acoustic.inject_source(p1, 0)
            fields = {"p0": p0, "p1": p1, "vp2": vp2, "damp": damp, "dt": dt}
        grids = {g: fields[g] for g in k.ir.grid_params}
        scalars = {n: fields[n] for n, _ in k.ir.scalar_params}
        kw = dict(iters=1, swap=swap, steps=STEPS, scalars=scalars)
        t0 = time.perf_counter()
        two = at.tune(k, grids, top_k=TOP_K, cache_dir=cdir, **kw)
        cold = time.perf_counter() - t0
        model = cm.default_model(cdir, "cuda")
        ex = at.tune(k, grids, top_k=None, cost_model=model, **kw)
        measured = {(b.cache_key(), f): s for b, f, s in ex.trials}
        out[name] = {
            "cold_s": cold, "timing": two.timing,
            "winner": describe(two.backend, two.fuse_steps),
            "seconds": two.seconds, "rank_error": two.rank_error,
            "exhaustive_winner": describe(ex.backend, ex.fuse_steps),
            "exhaustive_s": ex.seconds, "ratio": two.seconds / ex.seconds,
            "ratio_in_exhaustive": measured[(two.backend.cache_key(),
                                             two.fuse_steps)] / ex.seconds,
            "rates": {rk: [r.bytes_per_s, r.overhead_s]
                      for rk, r in model._rates.items()}}
        del grids, fields, scalars
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=pathlib.Path)
    ap.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds a tree's run may take")
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker.resolve())))
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
            [sys.executable, __file__, "--worker", str(tree)],
            capture_output=True, text=True, timeout=args.timeout)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        record["runs"].append({"tree": str(tree), "workloads": run})
        for name, r in run.items():
            t = r["timing"]
            print(f"{tree} {name}: cold two-stage tune {r['cold_s']:.2f} s "
                  f"(calibrate {t['calibrate']:.2f}, predict "
                  f"{t['predict']:.2f}, build {t['build']:.2f}, measure "
                  f"{t['measure']:.2f}); winner {r['winner']} "
                  f"{r['seconds']:.6f} s = {r['ratio']:.3f}x the exhaustive "
                  f"{r['exhaustive_winner']} ({r['ratio_in_exhaustive']:.3f}x "
                  f"in its run); rank_error {r['rank_error']}", flush=True)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
