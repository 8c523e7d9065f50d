"""Per-device accounting of one eager step on a mesh: FLOPs, HBM bytes,
collective bytes and temporary bytes (the counterpart of the JAX
package's ``launch/hlo_analysis.py``).

The JAX package walks a step's compiled HLO.  The port has no HLO: an
``Account`` walks the step as it runs, through a ``TorchDispatchMode``
that sees every aten op.  Run on a mesh of ``meta`` shards
(``launch/mesh.py``, ``devices=[torch.device("meta")]``) nothing is
computed or allocated, so a step of a production mesh is accounted on a
CPU.

Per op (``Stats``, the fields and summary of the JAX walk):

    dot   — the FLOPs of ``torch.utils.flop_counter``'s formula registry
            (mm, bmm, addmm, baddbmm, convolution and their backward)
    vec   — |result| per elementwise arithmetic op and per reduction
            (the JAX walk's op classes, ``_VEC``)
    transcendental — |result| per exp/log/tanh/sqrt/sigmoid/... op,
            weighted ×4 in ``total_flops`` (``_TRANSCENDENTAL``)
    HBM bytes — inputs plus outputs of every op that materializes a
            result; views, allocations and bookkeeping ops move nothing,
            index reads and in-place scatters charge twice the moved
            slice.  This is the port's eager traffic, one op at a time,
            not XLA's count after fusion: the two are reported side by
            side, never held equal.

A hand-written kernel is one operator of the ``repro_torch`` namespace
(``torch.library``), one op to the walk whatever runs inside it,
charged by ``_KERNELS``: K6 (``causal_conv1d``) 2·cw vec FLOPs an output
(a depthwise conv is no contraction) and its x, w and output bytes.

Collectives are recorded where the port issues them (``record``: the
FSDP gathers of ``models/sharded.py``, the sums of partials, the stencil
layer's slab copies), each charged per device by the ring model of the
JAX walk (``_coll_moved``, from the result bytes a device holds).

**Attribution.**  On a meta mesh every shard sits on the one meta device:
a ``Sharded`` stack holds all of a group's model shards' blocks, a
parameter slab all of a leaf's distinct blocks, and a replicated value is
one tensor for every shard that, on a real mesh, holds its own copy.  An
op's per-device cost is its executed cost times ``r / n_devices``, where
``r`` is the number of devices that each do the whole op on a real mesh
(``place``): 1 for an op on a stack of shards' blocks (each device does
its row), the group's model-shard count for an op on a replicated value,
``n_devices / rows`` for an op on a slab of ``rows`` distinct blocks
(``lead``: the leading axis of every operand stacks blocks).
``models/sharded.py`` knows which, and tags each op it runs; an op's
autograd nodes carry its tag, so its backward pass is charged alike.  The
one-process totals are reported as ``executed``: what one card does when
it holds every shard.  Temporary bytes are the peak of the step's own
allocations live at once, each weighted by the share of it one device
holds (``spread``: data groups run one after another, so one group's
pass is live at a time).

**Loops.**  ``trips(items)`` is a loop of the step (microbatches, data
groups): under ``Account(sample=True)`` it runs the first item and
charges it ``len(items)`` times, as the JAX walk multiplies a ``while``
body by its trip count; the costs outside the loop (the optimizer) are
charged once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Stats", "Account", "summarize", "record", "default_place",
           "lead", "call", "trips", "repeated", "hidden", "active"]


# ---------------------------------------------------------------------------
# stats (the JAX walk's)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Stats:
    dot_flops: float = 0.0
    vec_flops: float = 0.0
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add_coll(self, op: str, moved: float, k: float = 1.0):
        self.coll_counts[op] = self.coll_counts.get(op, 0.0) + k
        self.coll_bytes[op] = self.coll_bytes.get(op, 0.0) + moved * k

    @property
    def total_flops(self) -> float:
        return self.dot_flops + self.vec_flops + 4 * self.transcendentals

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def _coll_moved(op: str, result_bytes: int, g: int) -> float:
    """Bytes a device moves in one collective of ``g`` devices whose
    result on the device is ``result_bytes`` (ring algorithms)."""
    if g <= 1:
        return 0.0 if op != "collective-permute" else float(result_bytes)
    ring = (g - 1) / g
    if op == "all-gather":
        return result_bytes * ring
    if op == "all-reduce":
        return 2 * result_bytes * ring
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "all-to-all":
        return result_bytes * ring
    return float(result_bytes)      # collective-permute


def summarize(st: Stats) -> Dict:
    return {
        "dot_flops": float(st.dot_flops),
        "vec_flops": float(st.vec_flops),
        "transcendentals": float(st.transcendentals),
        "total_flops": float(st.total_flops),
        "hbm_bytes": float(st.hbm_bytes),
        "collective_counts": {k: round(v, 1)
                              for k, v in st.coll_counts.items()},
        "collective_bytes": {k: float(v) for k, v in st.coll_bytes.items()},
        "total_collective_bytes": float(st.collective_bytes),
    }


# ---------------------------------------------------------------------------
# op classes (aten names, trailing "_" of in-place forms dropped)
# ---------------------------------------------------------------------------
_VEC = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
    "logical_not", "neg", "abs", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "clamp", "clamp_min", "clamp_max", "floor", "ceil", "round", "sign",
    "remainder", "fmod", "square", "relu", "threshold_backward", "masked_fill",
    "addcmul", "addcdiv", "lerp", "reciprocal", "sigmoid_backward",
    "tanh_backward", "_softmax_backward_data", "_log_softmax_backward_data",
    "_foreach_add", "_foreach_sub", "_foreach_mul", "_foreach_div",
    "_foreach_addcmul", "_foreach_addcdiv", "_foreach_lerp", "_foreach_neg",
    # reductions: |result| each, as the JAX walk charges ``reduce``
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "any",
    "all", "prod", "var", "std", "var_mean", "cumsum", "cumprod", "cummax",
    "norm", "linalg_vector_norm", "_foreach_norm", "topk", "sort",
}
_TRANSCENDENTAL = {
    "exp", "log", "tanh", "sqrt", "rsqrt", "pow", "sigmoid", "sin", "cos",
    "expm1", "log1p", "erf", "atan2", "silu", "gelu", "softplus",
    "log_sigmoid_forward", "_softmax", "_log_softmax", "logsumexp",
    "silu_backward", "gelu_backward", "softplus_backward",
    "log_sigmoid_backward", "_foreach_sqrt", "_foreach_exp", "_foreach_pow",
}
# materialize nothing: allocations and bookkeeping
_NO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
    "set", "resize", "is_same_size", "_has_compatible_shallow_copy_type",
    "record_stream", "_make_dep_token",
}
# write their result only
_FILLS = {"zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
          "new_zeros", "new_ones", "new_full", "fill", "zero", "arange",
          "scalar_tensor", "randn", "rand", "normal", "uniform", "randint",
          "_foreach_zero"}
# read a slice (charged twice the result, as the JAX walk's dynamic-slice)
_READS = {"index_select", "gather", "index", "embedding", "take_along_dim",
          "masked_select"}
# in-place writes of an update (charged twice the update)
_WRITES = {"index_add", "index_put", "_index_put_impl", "scatter",
           "scatter_add", "index_copy", "masked_scatter", "copy"}


def _nbytes(t) -> int:
    """Bytes of a tensor's elements (a broadcast dimension, stride 0,
    counted once)."""
    n = t.element_size()
    for s, st in zip(t.shape, t.stride()):
        if st != 0:
            n *= s
    return n


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _tensors(x)]
    return []


# ---------------------------------------------------------------------------
# places: who does an op on a real mesh
# ---------------------------------------------------------------------------
# a place is (r, spread): the op's executed cost stands for r devices each
# doing all of it (per device: r / n_devices of the cost); spread: the
# number of data groups that run one after another (memory: r · spread /
# n_devices of an allocation is one device's).  LEAD: r from each
# operand's leading axis (n_devices / rows).
LEAD = "lead"
LEAD_ARRIVAL = "lead-arrival"          # LEAD, in an AccumulateGrad node
_DEFAULT = (1, 1)
_TAG = "op_analysis_place"

_ACTIVE: Optional["Account"] = None


def active() -> Optional["Account"]:
    """The account being kept, or None."""
    return _ACTIVE


class Account:
    """The account of what runs inside ``with Account(n_devices): ...``.

    ``per_device`` and ``executed`` are ``Stats``; ``temp_bytes`` and
    ``executed_temp_bytes`` the peak of the block's own allocations live
    at once (one device's share, and all of them); ``kernels[name]`` the
    hand-written kernel ops run (``_KERNELS``, loop trips counted);
    ``n_ops`` the ops walked (loop trips counted, views not).
    ``sample=True``: ``trips`` runs a loop's first item only and charges
    it for every item."""

    def __init__(self, n_devices: int, sample: bool = False):
        self.n_devices = int(n_devices)
        self.sample = bool(sample)
        self.per_device = Stats()
        self.executed = Stats()
        self.kernels: Dict[str, float] = {}
        self.n_ops = 0.0
        self.temp_bytes = 0.0
        self.executed_temp_bytes = 0.0
        self._live: Dict[int, Tuple[float, int]] = {}
        self._live_w = 0.0
        self._live_x = 0
        self._scale = 1.0
        self._explicit: List = []       # places pushed by ``call``/``lead``
        self._defaults: List = []       # places of ``default_place``
        self._hidden = 0                # ops not walked (``hidden``)
        self._mode = None

    # -- scope -------------------------------------------------------------------
    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("an account is already being kept")
        _ACTIVE = self
        self._mode = _Walker(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        try:
            self._mode.__exit__(*exc)
        finally:
            _ACTIVE, self._mode = None, None
            self._live.clear()
        return False

    # -- places ------------------------------------------------------------------
    def _place(self):
        if self._explicit:
            return self._explicit[-1]
        node = torch._C._current_autograd_node()
        if node is not None:
            if type(node).__name__ == "AccumulateGrad":
                return LEAD_ARRIVAL     # a gradient into a parameter slab
            p = node.metadata.get(_TAG)
            if p is not None:
                return p
        return self._defaults[-1] if self._defaults else _DEFAULT

    def _r(self, place, ts) -> float:
        if place in (LEAD, LEAD_ARRIVAL):
            t = next((t for t in ts if t.dim() > 0), None)
            return self.n_devices / t.shape[0] if t is not None else 1.0
        return float(place[0])

    # -- charges -----------------------------------------------------------------
    def _charge(self, place, ts, dot=0.0, vec=0.0, trans=0.0, nbytes=0.0):
        r = self._r(place, ts)
        w = self._scale * r / self.n_devices
        x = self._scale
        for st, k in ((self.per_device, w), (self.executed, x)):
            st.dot_flops += dot * k
            st.vec_flops += vec * k
            st.transcendentals += trans * k
            st.hbm_bytes += nbytes * k

    def record(self, op: str, result_bytes: float, group_size: int,
               devices: int = 1) -> None:
        """``devices`` devices each take part in one ``op`` over
        ``group_size`` devices with ``result_bytes`` of result each."""
        moved = _coll_moved(op, result_bytes, group_size)
        if moved == 0.0 and op != "collective-permute":
            return
        k = self._scale * devices
        self.per_device.add_coll(op, moved, k / self.n_devices)
        self.executed.add_coll(op, moved, k)

    # -- temporaries ---------------------------------------------------------------
    def _alloc(self, place, t: torch.Tensor) -> None:
        try:
            s = t.untyped_storage()
        except Exception:                # a tensor without storage
            return
        key = s._cdata
        if key in self._live:
            return
        n = s.nbytes()
        if place in (LEAD, LEAD_ARRIVAL):
            w = n / t.shape[0] if t.dim() > 0 else float(n)
        else:
            w = n * place[0] * place[1] / self.n_devices
        self._live[key] = (w, n)
        self._live_w += w
        self._live_x += n
        self.temp_bytes = max(self.temp_bytes, self._live_w)
        self.executed_temp_bytes = max(self.executed_temp_bytes, self._live_x)
        weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        got = self._live.pop(key, None)
        if got is not None:
            self._live_w -= got[0]
            self._live_x -= got[1]

    # -- the walk ------------------------------------------------------------------
    def _op(self, func, args, kwargs, out) -> None:
        if self._hidden:
            return
        name = func.overloadpacket.__name__
        base = name[:-1] if name.endswith("_") and not name.endswith("__") else name
        place = self._place()
        outs = _tensors(out)
        if not func.is_view and not any(r.alias_info is not None
                                        for r in func._schema.returns):
            for t in outs:                  # fresh storages only
                self._alloc(place, t)
        if place is LEAD_ARRIVAL and base == "detach":
            # a gradient's first arrival into a parameter slab (autograd
            # keeps the tensor): charged as the accumulation it stands
            # for, as XLA adds a microbatch's gradient into a zeroed carry
            self.n_ops += self._scale
            n = outs[0]
            self._charge(LEAD, outs, vec=float(n.numel()), nbytes=3.0 * _nbytes(n))
            return
        if func.is_view or base in _NO_BYTES:
            return
        ins = _tensors((args, kwargs))
        if func.namespace == "repro_torch":      # a hand-written kernel
            flops, nbytes = _KERNELS[base](*args, **kwargs)
            self.kernels[base] = self.kernels.get(base, 0.0) + self._scale
            self.n_ops += self._scale
            self._charge(place, outs + ins, vec=flops, nbytes=nbytes)
            return
        if base.startswith("_foreach_"):
            self._foreach(base, place, args, outs)
            return
        self.n_ops += self._scale
        dot = vec = trans = 0.0
        packet = func.overloadpacket
        if packet in _FLOPS:
            dot = float(_FLOPS[packet](*args, **kwargs, out_val=out))
        else:
            n_out = float(sum(t.numel() for t in outs[:1]))
            if base in _VEC:
                vec = n_out
            elif base in _TRANSCENDENTAL:
                trans = n_out
        nbytes = self._bytes(base, name, ins, outs)
        self._charge(place, outs + ins, dot, vec, trans, nbytes)

    def _bytes(self, base, name, ins, outs) -> float:
        if base in _FILLS:
            return float(sum(_nbytes(t) for t in outs))
        if base in _READS:
            return 2.0 * sum(_nbytes(t) for t in outs)
        if base in _WRITES and name.endswith("_") and len(ins) > 1:
            return 2.0 * _nbytes(ins[-1])            # the update
        return float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))

    def _foreach(self, base, place, args, outs) -> None:
        """A ``_foreach_`` op: each list position charged as an op of its
        own (its own leading axis under ``lead``)."""
        lists = [a for a in args if isinstance(a, (list, tuple))]
        n = len(lists[0]) if lists else 0
        others = [a for a in args if isinstance(a, torch.Tensor)]
        for i in range(n):
            ti = [l[i] for l in lists if isinstance(l[i], torch.Tensor)] + others
            oi = [outs[i]] if len(outs) == n else []
            self.n_ops += self._scale
            n_el = float(ti[0].numel()) if ti else 0.0
            vec = n_el if base in _VEC else 0.0
            trans = n_el if base in _TRANSCENDENTAL else 0.0
            nbytes = float(sum(_nbytes(t) for t in ti) + sum(_nbytes(t) for t in oi))
            if base in _FILLS:
                nbytes = float(sum(_nbytes(t) for t in ti[:1]))
            self._charge(place, ti, 0.0, vec, trans, nbytes)


def _conv1d_cost(x, w):
    """K6: 2·cw FLOPs an output; x and w read, the output written."""
    return (2.0 * w.shape[0] * x.numel(),
            float((2 * x.numel() + w.numel()) * x.element_size()))


# the hand-written kernels' operators (``torch.ops.repro_torch``): name →
# (their inputs → (vec FLOPs, bytes))
_KERNELS = {"causal_conv1d": _conv1d_cost}


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return {k: v for k, v in flop_registry.items()
            if isinstance(k, torch._ops.OpOverloadPacket)}


_FLOPS = _flop_registry()


class _Walker(TorchDispatchMode):
    def __init__(self, account: Account):
        super().__init__()
        self.account = account

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.account._op(func, args, kwargs, out)
        return out


# ---------------------------------------------------------------------------
# what the step's code calls (each a no-op without an account)
# ---------------------------------------------------------------------------
def record(op: str, result_bytes: float, group_size: int, devices: int = 1) -> None:
    """Charge one collective to the account being kept, if any:
    ``devices`` devices each take part in ``op`` (``"all-gather"``,
    ``"all-reduce"``, ``"reduce-scatter"``, ``"all-to-all"``,
    ``"collective-permute"``) over ``group_size`` devices, holding
    ``result_bytes`` of its result each."""
    if _ACTIVE is not None:
        _ACTIVE.record(op, result_bytes, group_size, devices)


@contextlib.contextmanager
def default_place(r: int = 1, spread: int = 1):
    """The ops of the block that no ``call`` and no autograd node placed
    stand for ``r`` devices each doing all of them, in one of ``spread``
    data groups run one after another (a data group's pass, its backward
    included)."""
    a = _ACTIVE
    if a is None:
        yield
        return
    a._defaults.append((int(r), int(spread)))
    try:
        yield
    finally:
        a._defaults.pop()


@contextlib.contextmanager
def lead():
    """The ops of the block work on stacks of distinct blocks (parameter
    slabs, ``[rows, *block]``): each operand's rows are spread over the
    mesh's devices."""
    a = _ACTIVE
    if a is None:
        yield
        return
    a._explicit.append(LEAD)
    try:
        yield
    finally:
        a._explicit.pop()


def call(fn, args=(), kwargs=None, r: int = 1, spread: int = 1, inputs=None):
    """``fn(*args, **kwargs)`` under ``place(r, spread)``, its autograd
    nodes (back to those of ``inputs``, default: the tensors of ``args``
    and ``kwargs``) tagged with the place so that its backward pass is
    charged alike."""
    kwargs = kwargs or {}
    a = _ACTIVE
    if a is None:
        return fn(*args, **kwargs)
    p = (int(r), int(spread))
    a._explicit.append(p)
    try:
        out = fn(*args, **kwargs)
    finally:
        a._explicit.pop()
    if torch.is_grad_enabled():
        _tag(out, (args, kwargs) if inputs is None else inputs, p)
    return out


def _tag(out, inputs, p) -> None:
    """Tag the autograd nodes between ``out`` and ``inputs`` with ``p``."""
    stop = {id(t.grad_fn) for t in _tensors(inputs) if t.grad_fn is not None}
    todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
    seen = set()
    while todo:
        n = todo.pop()
        if n is None or id(n) in stop or id(n) in seen:
            continue
        seen.add(id(n))
        if type(n).__name__ == "AccumulateGrad" or _TAG in n.metadata:
            continue
        n.metadata[_TAG] = p
        todo.extend(f for f, _ in n.next_functions)


class trips:
    """A loop of the step over ``items``.  Without a sampling account it
    runs them all; under ``Account(sample=True)`` it runs the first and
    charges it for each (``n`` items, ``ran`` run).  ``fill(results)``
    repeats a list of the run items' results to one a loop item."""

    def __init__(self, items):
        self.items = list(items)
        self.n = len(self.items)
        a = _ACTIVE
        self.ran = 1 if (a is not None and a.sample and self.n > 1) else self.n

    def __iter__(self):
        if self.ran == self.n:
            yield from self.items
            return
        a = _ACTIVE
        a._scale *= self.n
        try:
            yield self.items[0]
        finally:
            a._scale /= self.n

    def fill(self, results: list) -> list:
        return results if self.ran == self.n else results * self.n


@contextlib.contextmanager
def repeated(n: int):
    """The block runs once what a mesh does ``n`` times over (a batch
    replicated over ``n`` data groups, decoded by one): its ops are
    charged ``n`` times."""
    a = _ACTIVE
    if a is None or n == 1:
        yield
        return
    a._scale *= n
    try:
        yield
    finally:
        a._scale /= n


@contextlib.contextmanager
def hidden():
    """Ops of the block that the step does not do (shape inference on
    global meta tensors) are not walked."""
    a = _ACTIVE
    if a is None:
        yield
        return
    a._hidden += 1
    try:
        yield
    finally:
        a._hidden -= 1
