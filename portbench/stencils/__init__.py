"""Each stencil's file here makes its seeded initial state on the device
(``make_state(cfg, gen, device) -> (tensors, scalars)``, plain PyTorch:
the same inputs go to the program and to the reference) and binds it to
the program's DSL (``bind(cfg, tensors, scalars, dtype) -> Program``,
which imports the program).  A configuration names its stencil."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Program:
    """What the drivers run: the kernel, its grids by name, the positional
    arguments of a call (grids, then scalars), the leapfrog pair (written,
    other), and the hooks a shot runs between steps: ``inject(t)`` adds
    the source's sample ``t``, ``record()`` returns the receivers' plane."""
    kernel: object
    grids: Dict[str, object]
    args: List[object]
    swap: Tuple[str, str]
    inject: Optional[Callable[[int], None]] = None
    record: Optional[Callable[[], object]] = None


def full_shape(cfg) -> Tuple[int, ...]:
    """A grid's shape with its halo of ``order`` cells on each side."""
    return tuple(n + 2 * cfg["order"] for n in cfg["shape"])


def interior(cfg) -> Tuple[slice, ...]:
    o = cfg["order"]
    return tuple(slice(o, o + n) for n in cfg["shape"])
