"""Training from the command line, on the card unless ``--device`` says
otherwise::

    python -m repro_torch.launch.train --arch recurrentgemma-9b \\
        --steps 20 --preset smoke [--device cpu]

``--preset smoke`` shrinks the arch to its reduced same-family config
(``configs.tiny``); ``--preset full`` needs the real config on the
production mesh and ``--ckpt-dir`` checkpointing with restarts, neither
ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.dsl import not_ported
from repro_torch.train import data, optimizer, train_loop


def main(argv=None):
    """Run ``--steps`` steps; prints loss, gradient norm and lr a step and
    the time; returns the losses logged."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b")
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

    if args.preset == "full":
        raise not_ported("launch.train --preset full (the production mesh)",
                         "queue 1, item 9")
    if args.ckpt_dir:
        raise not_ported("launch.train --ckpt-dir (checkpoints and restarts)",
                         "queue 1, item 7")
    cfg = configs.tiny(configs.get(args.arch))
    seq = args.seq_len or 128
    gb = args.global_batch or 8
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=gb)
    batch_fn = data.make_batch_fn(cfg, shape, seed=args.seed)

    oc = optimizer.OptConfig(lr=args.lr, warmup_steps=args.warmup,
                             total_steps=max(args.steps, 1))
    tc = train_loop.TrainConfig(opt=oc, n_microbatches=args.microbatches)
    step_fn = train_loop.make_train_step(cfg, tc)
    state = train_loop.init_state(cfg, device=args.device, seed=args.seed)

    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        state, metrics = step_fn(state, batch_fn(step))
        if step % args.log_every == 0:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1):.2f} s/step) on "
          f"{train_loop.tree_leaves(state['params'])[0].device}")
    return losses


if __name__ == "__main__":
    main()
