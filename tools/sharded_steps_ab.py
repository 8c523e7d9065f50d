"""Wall time of the sharded steps that ``chip_smoke.py`` times in phases
16 (a) and 17, for an A/B of two trees on one card.

    python tools/sharded_steps_ab.py --src SRC [--cases 16a,17a,17b]

imports ``repro_torch`` from ``SRC`` (a tree's ``src`` directory) and
prints one ``AB {...}`` JSON line a case: the wall ms of each step (host
clock, the card synchronized around each) and the median of all but the
first.  Cases (phase 16 (a) and 17's configurations, random weights from
seed 0, no gates):

- ``16a``: recurrentgemma-9b, 3 layers, bf16, 2 × 4096 tokens, the train
  step on a (2, 2) mesh of the card (``TRAIN_STEPS`` steps);
- ``17a``: recurrentgemma-9b, 3 layers, f32, 2 rows, the decode step on a
  (2, 2) mesh, a cache of 24 positions (``DECODE_STEPS`` steps);
- ``17b``: granite-8b whole, f32, 16 rows, the decode step on the
  production mesh (16, 16), a cache of 4096 positions (``BIG_STEPS``
  steps).

Run parent, change, change, parent in one call to compare two trees.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

TRAIN_STEPS, DECODE_STEPS, BIG_STEPS = 6, 23, 5


def _timed(torch, fn, n):
    ms = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def train_16a(torch):
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import data, optimizer, train_loop
    cfg = dataclasses.replace(configs.get("recurrentgemma-9b"), n_layers=3)
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
    shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=4096, global_batch=2)
    batch_fn = data.make_batch_fn(cfg, shape, seed=0)
    batches = [batch_fn(s) for s in range(TRAIN_STEPS)]
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(warmup_steps=1,
                                                        total_steps=TRAIN_STEPS))
    state = {"s": train_loop.init_sharded_state(cfg, mesh, seed=0)}
    _, step = train_loop.compile_train_step(cfg, tc, mesh, batches[0])

    def one(i):
        state["s"], m = step(state["s"], batches[i])
        float(m["loss"])
    return _timed(torch, one, TRAIN_STEPS)


def _decode(torch, cfg, mesh_shape, rows, cache_len, steps, production=False):
    from repro_torch import sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import api
    from repro_torch.serving import serve_loop
    mesh = mesh_mod.make_production_mesh() if production else \
        mesh_mod.make_mesh(mesh_shape, ("data", "model"))
    params = api.init_params(cfg, device="cuda", seed=0)
    placed = sharding.device_put(params, sharding.param_shardings(
        cfg, mesh, api.init_params(cfg, device="meta")), donate=True)
    del params
    spec = api.init_cache(cfg, rows, api.decode_cache_len(cfg, cache_len), device="cuda")
    plan, step = serve_loop.compile_serve_step(cfg, mesh, spec)
    cache = {"c": sharding.device_put(spec, plan.cache_shardings, donate=True)}
    del spec
    gen = torch.Generator(device="cpu").manual_seed(0)
    cur = {"t": torch.randint(0, cfg.vocab, (rows, 1), generator=gen,
                              dtype=torch.int32).cuda()}

    def one(i):
        nxt, cache["c"] = step(placed, cache["c"], cur["t"])
        cur["t"] = nxt.to("cuda")
    return _timed(torch, one, steps)


def decode_17a(torch):
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("recurrentgemma-9b"), n_layers=3,
                              dtype="float32")
    return _decode(torch, cfg, (2, 2), 2, 24, DECODE_STEPS)


def decode_17b(torch):
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("granite-8b"), dtype="float32")
    return _decode(torch, cfg, None, 16, 4096, BIG_STEPS, production=True)


CASES = {"16a": train_16a, "17a": decode_17a, "17b": decode_17b}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    for name in args.cases.split(","):
        ms = CASES[name](torch)
        print("AB " + json.dumps({"src": args.src, "case": name,
                                  "ms": [round(t, 2) for t in ms],
                                  "median_after_first": statistics.median(ms[1:])}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
