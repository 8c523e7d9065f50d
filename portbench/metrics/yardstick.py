"""The benchmark's own yardstick: the card's published peaks and the work a
window asks of it, counted from the configuration alone.

Nothing here reads the program.  The operations of a stencil are those of
its expression as written (``flops_per_point`` in the configuration file);
the bytes count each grid the stencil reads once and each grid it writes
once, per boundary at which the user's program can observe the state: once
a solve in an ``st.timeloop`` without hooks, once a window where a hook
runs between windows, once a step where ``st.map`` is called step by step.
A kernel that keeps the state on chip between steps (temporal blocking)
then reads higher against the same least time, and never above 100 %.
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside
# the tensor cores, both at the full 700 W power limit.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}}


def peaks(kind: str) -> Mapping[str, float]:
    """The published peaks of card ``kind``; ``KeyError`` for a card the
    table does not hold (no roofline is read against a guess)."""
    return PEAKS[kind]


def points(cfg) -> int:
    """Interior points of the configuration's grid."""
    return math.prod(cfg["shape"])


def itemsize(cfg) -> int:
    return {"f32": 4, "bf16": 2, "f64": 8}[cfg["dtype"]]


def flops(cfg, steps: int) -> float:
    """Operations of ``steps`` applications of the stencil's expression."""
    return float(cfg["flops_per_point"]) * points(cfg) * steps


def bytes_moved(cfg, boundaries: int) -> float:
    """Compulsory bytes of ``boundaries`` observable states: each grid read
    once and each grid written once per boundary."""
    grids = len(cfg["reads"]) + len(cfg["writes"])
    return float(grids * points(cfg) * itemsize(cfg)) * boundaries


def least_seconds(cfg, steps: int, boundaries: int, kind: str) -> Tuple[float, str]:
    """(least time in seconds, "operations" or "bytes"): the larger of the
    operations over the f32 peak and the bytes over the memory peak."""
    pk = peaks(kind)
    t_ops = flops(cfg, steps) / pk["f32_flops_per_s"]
    t_bytes = bytes_moved(cfg, boundaries) / pk["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
