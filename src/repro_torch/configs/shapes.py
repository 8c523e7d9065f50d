"""Assigned input shapes (the JAX package's ``configs/shapes.py``:
``ShapeSpec``, ``SHAPES`` and ``applicable``; its ``input_specs`` are
abstract JAX arrays for the dry run, ROADMAP.md queue 1, item 11.4):

  train_4k      seq_len=4096    global_batch=256   (training step)
  prefill_32k   seq_len=32768   global_batch=32    (inference prefill)
  decode_32k    seq_len=32768   global_batch=128   (one-token decode, KV
                                                    cache of seq_len)
  long_500k     seq_len=524288  global_batch=1     (long-context decode;
                                                    sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from .base import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "applicable"]


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


def _subquadratic(cfg: ModelConfig) -> bool:
    """Archs with O(window)/O(1) decode state: SSM, hybrid, or SWA."""
    return cfg.family in ("ssm", "hybrid") or bool(cfg.window)


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skip): ``long_500k`` needs sub-quadratic
    attention; pure full-attention archs skip it.  (No encoder-only archs
    are assigned, so decode shapes run everywhere else.)"""
    if shape.name == "long_500k" and not _subquadratic(cfg):
        return False, ("pure full-attention arch: 500k-context decode has "
                       "no sub-quadratic structure (documented skip)")
    return True, ""
