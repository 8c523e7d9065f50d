"""Readings that set a cell's limits: the check's numbers for whole solves
of the timed path on many seeds, and for its control, the program's own
path in the precision below the configuration's (bf16 grids for f32).

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ... \\
        --control-seeds 101 102 103 [--out FILE]

Each solve runs exactly as in a run's window (the cell's driver, its
reset, hooks and kernels), then the plain reference works it out again.
Prints one JSON line a solve and, last, for each number the largest
reading of the program (the lower reading) and the smallest of the
control (the upper reading).  The benchmark's own runs never run this.
"""
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT / "src"), str(ROOT)]

import argparse  # noqa: E402
import json  # noqa: E402

CONTROL_DTYPE = {"f32": "bf16", "f64": "f32"}


def readings(cell, seeds, dtype: str, device, emit=print) -> list:
    """One solve a seed on the program with grids in ``dtype``; the check's
    numbers of each."""
    import torch
    from portbench import harness
    rows = []
    for seed in seeds:
        init, scalars, driver = harness.build(cell, seed, device, dtype)
        driver.warmup()
        t0 = time.perf_counter()
        driver.solve()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        got, schedule = driver.outputs(), driver.schedule
        del driver
        t0 = time.perf_counter()
        checks = harness.judge(cell, got, schedule, init, scalars)
        row = {"seed": seed, "dtype": dtype, "solve_s": solve_s,
               "reference_s": time.perf_counter() - t0,
               "checks": {c.name: c.value for c in checks}}
        emit(json.dumps(row))
        rows.append(row)
        del got, init
    return rows


def summary(program: list, control: list) -> dict:
    names = program[0]["checks"] if program else control[0]["checks"]
    return {n: {"lower": max((r["checks"][n] for r in program), default=None),
                "upper": min((r["checks"][n] for r in control), default=None)}
            for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None, help="also write the rows here (JSON)")
    args = ap.parse_args(argv)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    program = readings(cell, args.seeds, cell.cfg["dtype"], "cuda")
    control = readings(cell, args.control_seeds, CONTROL_DTYPE[cell.cfg["dtype"]], "cuda")
    summ = summary(program, control)
    print(json.dumps({"workload": args.workload, "summary": summ}))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "program": program, "control": control,
             "summary": summ}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
