"""Serving example on the PyTorch/CUDA port: batched greedy generation over
every cache family — full KV (granite), SWA rolling buffer (mixtral),
recurrent state (xLSTM), RG-LRU state with the temporal conv
(recurrentgemma: K6 on the card), encoder-decoder (whisper).

    PYTHONPATH=src python examples/torch_port/serve_lm.py               # card
    PYTHONPATH=src python examples/torch_port/serve_lm.py --device cpu

Each decoder config is the JAX package's tiny variant of the same family
(``configs.tiny``) with random parameters from ``api.init_params(seed=0)``;
a ``BatchServer`` of 4 slots drains 6 requests.  Whisper transcribes two
streams of frame embeddings through ``Generator.generate(frame_embeds=)``.
"""
import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.core.dsl import resolve_device
from repro_torch.models import api
from repro_torch.serving.serve_loop import BatchServer, GenConfig, Generator

DECODERS = ("granite-8b", "mixtral-8x7b", "xlstm-1.3b", "recurrentgemma-9b")


def decoder_demo(name, cfg, params, max_new=8) -> dict:
    """Six requests of 4–11 prompt tokens drawn by
    ``numpy.random.default_rng(0)`` through a 4-slot ``BatchServer``."""
    rng = np.random.default_rng(0)
    server = BatchServer(cfg, params, batch_size=4,
                         gen=GenConfig(max_new_tokens=max_new))
    for _ in range(6):
        server.submit(rng.integers(0, cfg.vocab, int(rng.integers(4, 12))),
                      max_new)
    t0 = time.perf_counter()
    done = server.run_until_drained()
    dt = time.perf_counter() - t0
    n = sum(len(r.result) for r in done.values())
    print(f"{name:20s} ({cfg.family}): {len(done)} reqs, {n} tokens, "
          f"{n / dt:6.1f} tok/s")
    return {"requests": len(done), "tokens": n, "tokens_per_s": n / dt,
            "results": {uid: r.result for uid, r in done.items()}}


def whisper_demo(cfg, params, max_new=8) -> dict:
    """Two streams of 16 random frame embeddings, 4-token prompts."""
    rng = np.random.default_rng(0)
    gen = Generator(cfg, params, GenConfig(max_new_tokens=max_new))
    prompts = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    frames = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    t0 = time.perf_counter()
    out = gen.generate(prompts, frame_embeds=frames)
    dt = time.perf_counter() - t0
    print(f"{'whisper-small':20s} (audio): transcribed 2 streams → "
          f"{out.shape} in {dt:.1f}s")
    return {"shape": list(out.shape), "seconds": dt, "tokens": out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out = {}
    for name in DECODERS:
        cfg = configs.tiny(configs.get(name))
        out[name] = decoder_demo(name, cfg, api.init_params(
            cfg, device=device, seed=0))
    cfg = configs.tiny(configs.get("whisper-small"))
    out["whisper-small"] = whisper_demo(cfg, api.init_params(
        cfg, device=device, seed=0))
    print("OK")
    return out


if __name__ == "__main__":
    main()
