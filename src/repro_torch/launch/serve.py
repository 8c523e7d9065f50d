"""Serving from the command line: batched greedy generation on a
smoke-sized model (``configs.tiny`` of the chosen architecture), on the
card unless ``--device`` says otherwise.

    python -m repro_torch.launch.serve --arch mixtral-8x7b \\
        --requests 8 --prompt-len 16 --max-new 8 [--device cpu]

Every family but the encoder-decoder (audio), whose requests carry frame
embeddings: serve it with ``Generator.generate(frame_embeds=)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.models import api
from repro_torch.serving.serve_loop import BatchServer, GenConfig


def main(argv=None):
    """Serve ``--requests`` random prompts; prints throughput, latency and
    the first results; returns the finished requests by uid."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = configs.tiny(configs.get(args.arch))
    if cfg.family == "audio":
        raise SystemExit("serve the encoder-decoder with "
                         "serve_loop.Generator.generate(frame_embeds=)")
    params = api.init_params(cfg, device=args.device, seed=args.seed)
    server = BatchServer(cfg, params, batch_size=args.batch_size,
                         gen=GenConfig(max_new_tokens=args.max_new,
                                       temperature=args.temperature,
                                       seed=args.seed))
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        server.submit(rng.integers(0, cfg.vocab, plen), args.max_new)

    t0 = time.perf_counter()
    done = server.run_until_drained()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.result) for r in done.values())
    lat = np.array([r.done_at - r.submitted_at for r in done.values()])
    print(f"served {len(done)} requests, {n_tok} new tokens "
          f"in {dt:.1f}s ({n_tok / dt:.1f} tok/s) on "
          f"{server.generator.device}")
    print(f"request latency: p50 {np.percentile(lat, 50):.3f}s  "
          f"p99 {np.percentile(lat, 99):.3f}s  "
          f"max {lat.max():.3f}s")
    for uid, r in sorted(done.items())[:4]:
        print(f"  req {uid}: {r.result[:8]}...")
    return done


if __name__ == "__main__":
    main()
