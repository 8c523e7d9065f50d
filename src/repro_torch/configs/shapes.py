"""Assigned input shapes (the JAX package's ``configs/shapes.py``:
``ShapeSpec`` and ``SHAPES``; its ``input_specs`` are abstract JAX arrays
for the dry run, ROADMAP.md queue 1, item 11.4):

  train_4k      seq_len=4096    global_batch=256   (training step)
  prefill_32k   seq_len=32768   global_batch=32    (inference prefill)
  decode_32k    seq_len=32768   global_batch=128   (one-token decode, KV
                                                    cache of seq_len)
  long_500k     seq_len=524288  global_batch=1     (long-context decode;
                                                    sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
