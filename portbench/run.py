"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with an NVIDIA card.  The cell, its
configuration, traffic, driver, metrics and limits are found by the names
in ``BENCHMARK.json`` (``portbench/harness.py``).  The run makes the
cell's state on the card from ``--seed``, warms up every shape the window
uses, measures closed-loop solves for ``--seconds`` (``--trace 1``: the
first ``harness.TRACE_SECONDS`` of them under ``torch.profiler``, for the
per-layer metrics), checks the last solve against the plain reference,
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``
(``--trace 1`` adds ``busy_s`` and ``window_s``), ``breakdown`` (traced)
and, last, ``checks``: each compared number with its limit, which are
also the last lines on standard error.

Exit codes: 0 with a result; 2 without a card (or with fewer than the
cell asks for); 3 when JAX or the JAX package was loaded; 1 on any other
error.  Build and kernel caches stay inside the checkout under
``build/``.
"""
import os
import pathlib
import sys
import time

T_IMPORT = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout's own packages, not this folder's loose modules
sys.path[:1] = [str(ROOT / "src"), str(ROOT)]
# caches at fixed paths inside the checkout, whatever the program defaults to
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def _started_ago() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        ago = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        at_import = ago - (time.perf_counter() - T_IMPORT)
        if 0.0 <= at_import < 60.0:
            return ago
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - T_IMPORT


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    marks = [("interpreter", _started_ago() - (time.perf_counter() - T_IMPORT))]

    from portbench import harness
    from portbench.metrics import yardstick
    cell = harness.load_cell(args.workload)
    import torch
    # the host drives the card from one thread; no pool of idle workers
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    marks.append(("imports", _started_ago()))
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", _started_ago, marks)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    kind = result["device"]["kind"]
    if kind in yardstick.PEAKS:
        s, bound = yardstick.least_seconds(cell.cfg, 1, 1, kind)
        print(f"roofline of one step and one observable state: {s * 1e3:.4f} ms "
              f"({bound}) at the published peaks; card {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
