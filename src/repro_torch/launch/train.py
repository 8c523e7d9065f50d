"""Training from the command line, on the card unless ``--device`` says
otherwise::

    python -m repro_torch.launch.train --arch mixtral-8x7b \\
        --steps 20 --preset smoke [--device cpu]

``--preset smoke`` shrinks the arch to its reduced same-family config
(``configs.tiny``) on one device; ``--preset full`` runs the real config
(``configs.get``, unreduced) on the production mesh
(``make_production_mesh``: 16 x 16 shards over the cards, or over
``--device``), the sequence and global batch ``train_4k``'s unless
``--seq-len`` and ``--global-batch`` say otherwise, through
``train_loop.compile_train_step``; the state is drawn and placed leaf by
leaf (``train_loop.init_sharded_state``).  ``--ckpt-dir DIR`` runs the steps
through ``fault_tolerance.run_with_restarts``: a checkpoint every
``--ckpt-every`` steps, a restart from the latest one after a failure, a
resume when ``DIR`` already holds checkpoints, and the straggler
watchdog's events reported at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import data, fault_tolerance, optimizer, train_loop


def main(argv=None):
    """Run ``--steps`` steps; prints loss, gradient norm and lr a step and
    the time; returns the losses logged."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.preset == "smoke":
        cfg = configs.tiny(configs.get(args.arch))
        seq = args.seq_len or 128
        gb = args.global_batch or 8
        mesh = None
    else:
        cfg = configs.get(args.arch)
        mesh = make_production_mesh(
            devices=None if args.device is None else [args.device])
        seq = args.seq_len or SHAPES["train_4k"].seq_len
        gb = args.global_batch or SHAPES["train_4k"].global_batch
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=gb)
    batch_fn = data.make_batch_fn(cfg, shape, seed=args.seed)

    oc = optimizer.OptConfig(lr=args.lr, warmup_steps=args.warmup,
                             total_steps=max(args.steps, 1))
    tc = train_loop.TrainConfig(opt=oc, n_microbatches=args.microbatches)
    shardings = None
    if mesh is None:
        step_fn = train_loop.make_train_step(cfg, tc)

        def init_fn():
            return train_loop.init_state(cfg, device=args.device, seed=args.seed)
        where = lambda st: train_loop.tree_leaves(st["params"])[0].device  # noqa: E731
    else:
        _, step_fn = train_loop.compile_train_step(cfg, tc, mesh, batch_fn(0))
        shardings = train_loop.state_shardings(cfg, mesh)

        def init_fn():
            return train_loop.init_sharded_state(cfg, mesh, seed=args.seed)
        where = lambda st: mesh  # noqa: E731

    losses = []

    def one_step(state, step):
        state, metrics = step_fn(state, batch_fn(step))
        if step % args.log_every == 0:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return state

    t0 = time.perf_counter()
    if args.ckpt_dir:
        wd = fault_tolerance.Watchdog()
        state = fault_tolerance.run_with_restarts(
            init_fn=init_fn, step_fn=one_step, n_steps=args.steps,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            shardings=shardings, watchdog=wd)
        if wd.events:
            print(f"straggler events: {len(wd.events)}")
    else:
        state = init_fn()
        for step in range(args.steps):
            state = one_step(state, step)
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1):.2f} s/step) on "
          f"{where(state)}")
    return losses


if __name__ == "__main__":
    main()
