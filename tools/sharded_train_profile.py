"""Where the time of the sharded train step goes on the card (a breakdown,
not a gate).

``chip_smoke.py`` phase 16 times the sharded steps; this script explains
them: (a) one bf16 step of ``--arch`` (default recurrentgemma-9b) cut to
``--layers`` (default 3; the encoder-decoder: that many encoder and
decoder layers each), 2 x 4096 tokens, unsharded and on a (2, 2) mesh of
the card, each under ``torch.profiler`` (wall time, the top entries by
device time, the most frequent operators; a MoE config's statistics pass
timed apart); (b) one bf16 step of ``--full-arch`` (default
phi3-mini-3.8b) whole, 16 x 512 tokens, on the production mesh (16, 16)
of the card, with its AdamW timed apart, and
one data group's forward and backward (recompute included) timed apart
(``--full-arch none`` skips it).  Each step follows a warm-up step.  Any
of the ten configs (``configs.ARCH_NAMES``) goes in either part.

    PYTHONPATH=src python3 tools/sharded_train_profile.py [--arch NAME]
        [--layers N] [--full-arch NAME|none] [--json PATH]

Needs a CUDA card (about 80 s at the defaults); prints the card's name and
power limit first and the record as JSON last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--full-arch", default="phi3-mini-3.8b")
    ap.add_argument("--json", help="also write the record to this file")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs, sharding
    from repro_torch.configs import shapes
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import api
    from repro_torch.models import sharded
    from repro_torch.train import data, optimizer, train_loop
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sync = torch.cuda.synchronize
    rec = {}

    stats_s = []
    statistics = train_loop.moe_statistics

    def timed_statistics(*a, **k):     # MoE's statistics pass, timed apart
        sync()
        t0 = time.perf_counter()
        out = statistics(*a, **k)
        sync()
        stats_s.append(time.perf_counter() - t0)
        return out
    train_loop.moe_statistics = timed_statistics

    def profiled(label, step, state, batch):
        sync()
        stats_s.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            float(m["loss"])
            sync()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        top = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in ka
                      if e.device_time_total > 0 and not e.key.startswith(("aten::", "cuda"))),
                     key=lambda r: -r[1])[:20]
        ops = sorted(((e.key, e.count) for e in ka if e.key.startswith("aten::")),
                     key=lambda r: -r[1])[:12]
        print(f"{label}: wall {1e3 * wall:.1f} ms")
        for key, ms, n in top:
            print(f"   {ms:9.2f} ms  {n:7d}  {key[:110]}")
        print(f"   most frequent operators: {ops}")
        rec[label] = {"wall_ms": 1e3 * wall, "top_device": top, "frequent_ops": ops}
        if stats_s:
            rec[label]["stats_pass_ms"] = 1e3 * sum(stats_s)
            print(f"   MoE statistics pass {1e3 * sum(stats_s):.1f} ms of it")
        return state

    # (a)
    cfg = configs.get(args.arch)
    n = args.layers
    cfg = dataclasses.replace(cfg, n_layers=2 * n, n_enc_layers=n, n_dec_layers=n) \
        if cfg.is_encdec else dataclasses.replace(cfg, n_layers=n)
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
    shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=4096, global_batch=2)
    batch_fn = data.make_batch_fn(cfg, shape, seed=0)
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(warmup_steps=1, total_steps=4))
    state = train_loop.init_state(cfg, seed=0)
    step = train_loop.make_train_step(cfg, tc)
    state, _ = step(state, batch_fn(0))
    state = profiled("a unsharded", step, state, batch_fn(1))
    del state
    torch.cuda.empty_cache()
    state = train_loop.init_sharded_state(cfg, mesh, seed=0)
    _, step = train_loop.compile_train_step(cfg, tc, mesh, batch_fn(0))
    state, _ = step(state, batch_fn(0))
    state = profiled("a sharded", step, state, batch_fn(1))
    del state, step
    torch.cuda.empty_cache()
    if args.full_arch == "none":
        return _report(rec, args.json)

    # (b)
    cfg = configs.get(args.full_arch)
    mesh = mesh_mod.make_production_mesh()
    shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=512, global_batch=16)
    batch = data.make_batch_fn(cfg, shape, seed=0)(0)
    state = train_loop.init_sharded_state(cfg, mesh, seed=0)
    _, step = train_loop.compile_train_step(cfg, train_loop.TrainConfig(), mesh, batch)
    state, _ = step(state, batch)
    apply_s = []
    apply = optimizer.apply

    def timed_apply(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = apply(*a, **k)
        sync()
        apply_s.append(time.perf_counter() - t0)
        return out
    train_loop.optimizer.apply = timed_apply
    try:
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        sync()
        wall = time.perf_counter() - t0
    finally:
        train_loop.optimizer.apply = apply
    g = sharded.groups(mesh)[0]
    held = [t for leaf in optimizer.tree_leaves(state["params"])
            for t in leaf.local_tensors()]
    for t in held:
        t.requires_grad_(True)
    rows = {k: torch.as_tensor(v[:1], device="cuda") for k, v in batch.items()}
    for _ in range(2):                    # the second pass is the one kept
        view = optimizer.tree_map(g.view, state["params"])
        sync()
        t0 = time.perf_counter()
        with sharding.use_activation_mesh(mesh), sharding.use_group(g):
            loss, _ = api.loss_fn(cfg, view, rows)
            sync()
            t1 = time.perf_counter()
            loss.parts[0].backward()
        sync()
        t2 = time.perf_counter()
    for t in held:
        t.grad = None
        t.requires_grad_(False)
    rec["b"] = {"step_s": wall, "adamw_s": apply_s[0], "groups": len(sharded.groups(mesh)),
                "group_forward_ms": 1e3 * (t1 - t0), "group_backward_ms": 1e3 * (t2 - t1)}
    print(f"b sharded step: {wall:.2f} s, AdamW {apply_s[0]:.2f} s; one of "
          f"{rec['b']['groups']} data groups: forward {rec['b']['group_forward_ms']:.1f} "
          f"ms, backward (recompute included) {rec['b']['group_backward_ms']:.1f} ms")
    return _report(rec, args.json)


def _report(rec, path) -> int:
    if path:
        pathlib.Path(path).write_text(json.dumps(rec, indent=1, default=str))
    print(json.dumps(rec, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
