"""End-to-end training on the PyTorch/CUDA port: trains a ~100M-param
dense LM for a few hundred steps with the full substrate — synthetic
deterministic data, AdamW + warmup-cosine, microbatched gradient
accumulation, checkpoint/restart, straggler watchdog.

    PYTHONPATH=src python examples/torch_port/train_lm.py --preset smoke
    PYTHONPATH=src python examples/torch_port/train_lm.py --preset 100m
        # the ~100M config, 300 steps of 16 × 512 on the card
    ... --device cpu                     # on the CPU (tests, CI)
    ... --ckpt-dir DIR                   # checkpoint every 50 steps and
                                         # resume from DIR's latest

The step is ``train_loop.make_train_step`` run eagerly (the JAX script
jits it).  The production-scale path (assigned archs, the production
mesh) is ``python -m repro_torch.launch.train --preset full``.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.dsl import resolve_device
from repro_torch.models import api
from repro_torch.train import data, fault_tolerance, optimizer, train_loop

# ~100M dense transformer (GPT-2-medium-ish, swiglu/rope/rmsnorm)
LM_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=2048, vocab=32768, act="swiglu", remat=False,
    scan_layers=True)


def preset(name: str):
    """→ (config, default steps, batch shape) of ``--preset name``."""
    if name == "smoke":
        cfg = dataclasses.replace(
            LM_100M, name="lm-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=4, d_ff=256, vocab=512)
        return cfg, 60, ShapeSpec("train", "train", seq_len=64, global_batch=8)
    return LM_100M, 300, ShapeSpec("train", "train", seq_len=512,
                                   global_batch=16)


def train(cfg, shape, steps, *, device, microbatches=1, ckpt_dir=None,
          ckpt_every=50, init_fn=None) -> list:
    """Train ``steps`` steps (resuming from ``ckpt_dir``'s latest checkpoint
    when it holds one); → the losses of the steps this call ran.
    ``init_fn`` gives the initial state (default: ``init_state(seed=0)``)."""
    batch_fn = data.make_batch_fn(cfg, shape, seed=0)
    tc = train_loop.TrainConfig(
        opt=optimizer.OptConfig(lr=3e-4, warmup_steps=20, total_steps=steps),
        n_microbatches=microbatches)
    step_fn = train_loop.make_train_step(cfg, tc)
    init_fn = init_fn or (lambda: train_loop.init_state(cfg, device=device,
                                                        seed=0))
    losses = []

    def one(state, step):
        state, m = step_fn(state, batch_fn(step))
        losses.append(float(m["loss"]))
        if step % 10 == 0 or step == steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:7.4f}  "
                  f"lr {float(m['lr']):.2e}", flush=True)
        return state

    if ckpt_dir:
        fault_tolerance.run_with_restarts(
            init_fn=init_fn, step_fn=one, n_steps=steps, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every, watchdog=fault_tolerance.Watchdog())
    else:
        state = init_fn()
        for s in range(steps):
            state = one(state, s)
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg, steps, shape = preset(args.preset)
    steps = args.steps or steps
    print(f"{cfg.name}: {api.param_count(cfg) / 1e6:.1f}M params, "
          f"{steps} steps @ {shape.global_batch}×{shape.seq_len}")
    losses = train(cfg, shape, steps, device=device,
                   microbatches=args.microbatches, ckpt_dir=args.ckpt_dir)

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss {first:.3f} → {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    assert last < first, "training failed to reduce loss"
    print("OK")
    return {"losses": losses, "first": float(first), "last": float(last),
            "params_m": api.param_count(cfg) / 1e6}


if __name__ == "__main__":
    main()
