"""Time K6's runs (time rows a thread walks) and its two builds on the card.

K6 (``kernels/conv1d``) takes ``ROWS`` (64) rows a run by default: a
shorter run launches more blocks but reloads its ``cw - 1`` halo rows
more often, a longer one fewer blocks.  This script times runs of 8 to
256 rows, and the lane build beside the vector build, in bf16 and f32 at
the training path's ``[2, 4099, 4096]`` and the prefill size
``[4, 2048, 4096]`` (cw=4), each call checked bit for bit against the plain
version, as device times of CUDA graphs of 20 calls replayed in turns
(the default first and last of each round).

    PYTHONPATH=src python3 tools/conv1d_tiles_ab.py [--rounds 3] [--json PATH]

Needs a CUDA card; prints the card's name and power limit, one line per
case (median ms over the rounds and the bound), and the whole record as
JSON on its last line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"train": (2, 4099, 4096), "prefill": (4, 2048, 4096)}
ROWS = (8, 16, 32, 64, 128, 256)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv1d import conv1d
    from repro_torch.kernels.conv1d.ref import causal_conv1d_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rates = cs.CARD_RATES.get(torch.cuda.get_device_name(0))
    _build.build_many([conv1d.source()])
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"device": smi, "default_rows": conv1d.ROWS, "cases": []}
    for dtype in (torch.bfloat16, torch.float32):
        for label, (B, T, W) in SHAPES.items():
            x = torch.randn((B, T, W), generator=gen, device="cuda").to(dtype)
            w = (0.3 * torch.randn((4, W), generator=gen,
                                   device="cuda")).to(dtype)
            want = causal_conv1d_ref(x, w)
            variants = [("vector", r) for r in ROWS] + [("lane", conv1d.ROWS)]
            fns = {}
            for build, rows in variants:
                got = conv1d.causal_conv1d_cuda(x, w, rows=rows, build=build)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    print(f"FAIL {label} {dtype} {build} rows={rows}",
                          file=sys.stderr)
                    return 1
                fns[(build, rows)] = (lambda b=build, r=rows:
                                      conv1d.causal_conv1d_cuda(x, w, rows=r,
                                                                build=b))
            default = ("vector", conv1d.ROWS)
            times = {v: [] for v in variants}
            for _ in range(args.rounds):
                order = [default] + [v for v in variants if v != default] \
                    + [default]
                for v in order:
                    times[v].append(cs.graph_ms(torch, fns[v], calls=20,
                                                replays=10))
            bound, _ = cs.bound_of(rates, 2 * x.numel() * x.element_size()
                                   + w.numel() * w.element_size(), 8 * x.numel())
            dname = str(dtype).split(".")[1]
            for (build, rows), ts in times.items():
                row = {"shape": [B, T, W], "label": label, "dtype": dname,
                       "build": build, "rows": rows,
                       "ms": statistics.median(ts), "all_ms": ts,
                       "bound_ms": bound}
                record["cases"].append(row)
                print(f"K6 {dname} {label} [{B}, {T}, {W}] {build} rows={rows}: "
                      f"{row['ms']:.4f} ms (bound {bound} ms; "
                      f"{', '.join(f'{t:.4f}' for t in ts)})", flush=True)
            del x, w, want, fns
            torch.cuda.empty_cache()
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
