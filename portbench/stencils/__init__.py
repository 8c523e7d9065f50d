"""Each stencil's file here makes its seeded initial state on the device
(``make_state(cfg, gen, device) -> (tensors, scalars)``, plain PyTorch:
the same inputs go to the program and to the reference), names the
program's DSL kernel (``kernel()``, which imports the program) and binds
the state to it (``bind(cfg, tensors, scalars, dtype) -> Program``).  A
configuration names its stencil, and its leapfrog pairs under ``swap``:
one pair ``[written, other]`` or a list of them."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Program:
    """What the drivers run: the kernel, its grids by name, the positional
    arguments of a call (grids, then scalars), the leapfrog pairs
    ((written, other), ...), each trading buffers after every step, and
    the hooks a shot runs between steps: ``inject(t)`` adds the source's
    sample ``t``, ``record()`` returns the receivers' plane."""
    kernel: object
    grids: Dict[str, object]
    args: List[object]
    pairs: Tuple[Tuple[str, str], ...]
    inject: Optional[Callable[[int], None]] = None
    record: Optional[Callable[[], object]] = None


def leapfrog_pairs(swap) -> Tuple[Tuple[str, str], ...]:
    """A configuration's ``swap``, one pair ``[written, other]`` or a list
    of pairs, as a tuple of (written, other) pairs."""
    def pair(p):
        return (isinstance(p, (list, tuple)) and len(p) == 2
                and all(isinstance(g, str) for g in p))
    pairs = [swap] if pair(swap) else list(swap or ())
    if not pairs or not all(pair(p) for p in pairs):
        raise ValueError(f"swap: a pair [written, other] or a list of pairs, not {swap!r}")
    return tuple((p[0], p[1]) for p in pairs)


def pair_grids(pairs) -> Tuple[str, ...]:
    """Every grid of every pair, in order."""
    return tuple(g for p in pairs for g in p)


def full_shape(cfg) -> Tuple[int, ...]:
    """A grid's shape with its halo of ``order`` cells on each side."""
    return tuple(n + 2 * cfg["order"] for n in cfg["shape"])


def interior(cfg) -> Tuple[slice, ...]:
    o = cfg["order"]
    return tuple(slice(o, o + n) for n in cfg["shape"])
