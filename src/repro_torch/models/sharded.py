"""The sharded execution of the LM families on a mesh (the port's
counterpart of what GSPMD makes of the JAX package's sharded train step).

One process drives every shard, as the stencil layer does
(``core/distributed.py``): a shard is a set of tensors on its mesh device,
and a collective is copies between shards' tensors.

* **Data groups.** The mesh positions that share one index along every
  axis but ``model`` form a data group (``groups``): its model shards.
  The sharded step runs the groups one after another, each on its rows of
  the batch, forward and backward, each adding its gradient into the
  shards' gradients, so only one group's gathered weights and activations
  are alive at a time.
* **Weights.** A parameter leaf is a ``sharding.ShardedTensor``.  Inside a
  group it is seen through ``Group.view``: at each use (so inside a layer
  that is recomputed in the backward pass) each model shard's block of
  the dimension bound to ``model`` is gathered across the other mesh axes
  (FSDP over ``data``): a ``torch.cat`` of the shards' tensors, whose
  backward is the reduce-scatter of the gradient into the shards.
* **Activations.** Model code runs unchanged on ``Sharded`` values: an
  activation's global shape, the dimension split over ``model`` (``sdim``;
  None: replicated) or a sum of partials, and its tensors.  The model
  shards a device holds keep their blocks stacked on a leading axis, one
  tensor a device (``stacks``), so that an operation is one launch a
  device, each shard computing its own block, rather than one a shard (a
  mesh may put all 256 shards on one card); a replicated value is one
  tensor a device.  Torch functions dispatch here
  (``__torch_function__``); a product whose contracted dimension is split
  gives partials, which ``sharding.constrain`` (at the JAX package's call
  sites) sums in f32 and rounds once.  Where the operands of a product are
  split along different dimensions, the one split along a contracted
  dimension is gathered first (Griffin's gates: ``u`` is gathered across
  model shards for ``wa`` and ``wi``).  The cross-entropy's logsumexp and
  the label's logit over vocab-split logits combine the shards' partial
  results.  An operation that would reduce or index along the split
  dimension, or one this module has no rule for, raises rather than
  compute a shard's part alone.  K6 runs once a model shard on its slice
  of the width (``local``).
* One autograd graph a group: the copies (``.to(device)``), ``torch.cat``,
  the stacks and the sums of partials are differentiable operations on the
  shards' tensors, so the gradients are exact by construction.

Under an ``op_analysis.Account`` each operation a device runs is tagged
with who does it on a real mesh (``Group.run``: one shard's row of a stack, or
every shard of a replicated value), and each copy between shards is
recorded as the collective it stands for: the FSDP gather of
``LeafView.materialize`` (an all-gather over the data axes; its
backward a reduce-scatter, and an all-reduce over the data groups that
hold copies of a piece), the sum of partials (an all-reduce), the
gather of a split value (an all-gather) and the cross-shard combines of
the logsumexp and the label gather (all-reduces).  A split of a
replicated value, and a write into the shard that owns a slot
(``_setitem``), move nothing.

Every family runs so (MoE's load-balancing loss takes the microbatch's
routing statistics across the groups: ``moe.AuxStats``).  The decode
step reads a cache through ``Group.local_view`` (the group's own rows,
views of the shards) and writes it in place: ``__setitem__`` on a
model-split value writes each shard's part of the written range.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.launch import op_analysis as _acct

__all__ = ["Group", "Sharded", "LeafView", "groups", "local"]


def _model_axis(mesh) -> Optional[int]:
    names = list(mesh.axis_names)
    return names.index("model") if "model" in names else None


def groups(mesh) -> List["Group"]:
    """The data groups of ``mesh``, in the order of its other axes."""
    k = _model_axis(mesh)
    sizes = mesh.devices.shape
    others = [range(s) if i != k else [None] for i, s in enumerate(sizes)]
    return [Group(mesh, idx) for idx in itertools.product(*others)]


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


class Group:
    """One data group: the model shards at mesh positions ``index`` (None
    at the model axis), their devices, and the layout operations between
    them.  ``held[device]`` lists the model shards on each device, in
    order (the rows of that device's stacks)."""

    def __init__(self, mesh, index):
        self.mesh = mesh
        self.index = tuple(index)
        k = _model_axis(mesh)
        self.m = mesh.devices.shape[k] if k is not None else 1
        self.positions = []
        for j in range(self.m):
            pos = list(self.index)
            if k is not None:
                pos[k] = j
            self.positions.append(tuple(pos))
        self.devices = [mesh.devices[p] for p in self.positions]
        self.held: Dict[torch.device, List[int]] = {}
        for j, d in enumerate(self.devices):
            self.held.setdefault(d, []).append(j)
        # shard j is row row_of[j] of its device's stack
        self.row_of = {j: js.index(j) for js in self.held.values() for j in js}
        self._plans: Dict = {}

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    @property
    def n_data(self) -> int:
        """The number of data groups of the mesh (the batch's split)."""
        return self.mesh.devices.size // self.m

    def run(self, dev, stacked: bool, fn, *args, inputs=None, **kwargs):
        """``fn(*args, **kwargs)``, one operation of device ``dev`` in this
        group: under an account, charged to each shard's row where
        ``stacked``, else in full to each shard ``dev`` holds
        (``op_analysis.call``)."""
        if _acct.active() is None:
            return fn(*args, **kwargs)
        return _acct.call(fn, args, kwargs, r=1 if stacked else len(self.held[dev]),
                          spread=self.n_data, inputs=inputs)

    def __repr__(self):
        return f"Group({self.index}, {self.m} model shards)"

    # -- values ------------------------------------------------------------------
    def replicate(self, t: torch.Tensor) -> "Sharded":
        """A plain tensor as a replicated value (copied to each device)."""
        return Sharded(self, {d: t.to(d) for d in self.held}, t.shape)

    def view(self, leaf: sharding.ShardedTensor) -> "LeafView":
        """The parameter ``leaf`` as this group sees it (gathered at use)."""
        return LeafView(self, leaf)

    def split_view(self, t: torch.Tensor, d: int, dev) -> torch.Tensor:
        """The blocks of ``t`` (whole along ``d``) that ``dev``'s shards
        hold, stacked on a new leading axis."""
        n = t.shape[d] // self.m
        u = t.unflatten(d, (self.m, n)).movedim(d, 0)
        js = self.held[dev]
        if js == list(range(js[0], js[0] + len(js))):
            return u.narrow(0, js[0], len(js))
        return u[torch.tensor(js, device=u.device)]

    def _local_rows(self, leaf: sharding.ShardedTensor):
        """(the leaf's model-split dimension or None, per device the rows
        of its slab that hold this group's shards' blocks, in held order:
        one for a value replicated over the model shards)."""
        d_model = None
        for d, ax in enumerate(leaf.sharding.dim_axes(leaf.ndim)):
            if "model" in ax:
                if ax != ("model",):
                    raise ValueError(f"{leaf}: dimension {d} split over {ax}")
                d_model = d
        rows = {}
        for dev, js in self.held.items():
            js = js if d_model is not None else js[:1]
            rows[dev] = [leaf.rows[dev][leaf.sharding.block_of(
                leaf.shape, self.positions[j])] for j in js]
        return d_model, rows

    def local_view(self, leaf: sharding.ShardedTensor) -> "Sharded":
        """A leaf split by rows over the data axes (a decode cache) as this
        group holds it: each device's blocks of its own rows, not gathered
        across the data groups.  A device's stack is a view of its slab
        (``_put`` lays a slab's rows out so that a group's are evenly
        spaced), so writes to the value write the leaf."""
        d_model, rows = self._local_rows(leaf)
        stacks = {dev: _rows_view(leaf.slabs[dev], idx) if d_model is not None
                  else leaf.slabs[dev][idx[0]] for dev, idx in rows.items()}
        block = leaf.sharding.block_of(leaf.shape, self.positions[0])
        shape = [(b - a) * (self.m if d == d_model else 1)
                 for d, (a, b) in enumerate(block)]
        return Sharded(self, stacks, shape, sdim=d_model)

    def write_back(self, leaf: sharding.ShardedTensor, value) -> None:
        """Write ``value`` (the group's rows of ``leaf``, e.g. a decode
        step's new state) into the leaf's blocks on each device, in place;
        a stack that is already the leaf's storage is left as it is."""
        d_model, rows = self._local_rows(leaf)
        if not isinstance(value, Sharded):
            value = self.replicate(value)
        value = self.relayout(value, d_model)
        with torch.no_grad():
            for dev, idx in rows.items():
                slab, src = leaf.slabs[dev], value.stacks[dev]
                dst = _rows_view(slab, idx) if d_model is not None else slab[idx[0]]
                if not _same_memory(src, dst):
                    self.run(dev, d_model is not None, dst.copy_, src)

    # -- layouts ----------------------------------------------------------------------
    def reduce(self, x: "Sharded") -> "Sharded":
        """Partials summed (in their wide dtype: a device's shards, then the
        devices in order on the first one), rounded once to the logical
        dtype, replicated."""
        acc = dev0 = None
        for d, s in x.stacks.items():
            part = self.run(d, True, lambda s: s.sum(0) if s.shape[0] > 1
                            else s.squeeze(0), s)
            if acc is None:
                acc, dev0 = part, d
            else:
                acc = self.run(d, True, lambda a, p: a + p.to(a.device), acc, part)
        _acct.record("all-reduce", acc.numel() * acc.element_size(), self.m,
                     devices=self.m)
        return self.replicate(self.run(dev0, False, acc.to, x.dtype, inputs=acc))

    def allgather(self, x: "Sharded") -> "Sharded":
        """A split value joined along its split dimension, replicated."""
        d = x.sdim
        _acct.record("all-gather", x.shape.numel() * x.dtype.itemsize, self.m,
                     devices=self.m)
        if len(x.stacks) == 1:
            (dev, s), = x.stacks.items()
            return Sharded(self, {dev: self.run(
                dev, False, lambda s: s.movedim(0, d).flatten(d, d + 1), s)}, x.shape)
        parts = x.parts
        return Sharded(self, {dev: self.run(
            dev, False, lambda: torch.cat([p.to(dev) for p in parts], dim=d),
            inputs=parts) for dev in self.held}, x.shape)

    def split(self, x: "Sharded", d: int) -> "Sharded":
        """A replicated value split along ``d`` (each shard its block)."""
        return Sharded(self, {dev: self.run(dev, True, self.split_view, t, d, dev)
                              for dev, t in x.stacks.items()}, x.shape, sdim=d)

    def relayout(self, x: "Sharded", d: Optional[int]) -> "Sharded":
        """``x`` split along ``d`` over the model shards (None: replicated)."""
        if x.partial:
            x = self.reduce(x)
        if x.sdim == d:
            return x
        if x.sdim is not None:
            x = self.allgather(x)
        return x if d is None else self.split(x, d)

    def constrain(self, x, axes) -> "Sharded":
        """``sharding.constrain`` inside this group: ``x`` in the layout
        ``resolve`` gives ``axes`` along the model axis."""
        if isinstance(x, LeafView):
            x = x.materialize()
        elif not isinstance(x, Sharded):
            x = self.replicate(x)
        spec = sharding.resolve(axes, tuple(x.shape), self.mesh)
        d = None
        for i, e in enumerate(spec):
            if e == "model" or (isinstance(e, tuple) and "model" in e):
                d = i
        return self.relayout(x, d)


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` are the same elements of one storage."""
    return a.untyped_storage()._cdata == b.untyped_storage()._cdata \
        and a.storage_offset() == b.storage_offset() and a.stride() == b.stride()


def _rows_view(slab: torch.Tensor, idx: List[int]) -> torch.Tensor:
    """Rows ``idx`` of ``slab`` (evenly spaced) as a view."""
    step = idx[1] - idx[0] if len(idx) > 1 else 1
    if step <= 0 or idx != list(range(idx[0], idx[-1] + 1, step)):
        raise ValueError(f"a group's rows {idx} of a slab are not evenly spaced")
    return slab[idx[0]:idx[-1] + 1:step]


class Sharded:
    """An activation (or a parameter seen by a group) over a group's model
    shards.  ``shape``: the global shape; ``sdim``: the dimension split
    over ``model`` (None: replicated); ``partial``: the value is the sum
    of the shards' parts (held in the wide dtype, ``dtype`` the logical
    one).  ``stacks[device]``: a split or partial value's blocks of the
    device's shards stacked on a leading axis (``Group.held`` order), a
    replicated value's one tensor."""

    def __init__(self, group: Group, stacks, shape, sdim: Optional[int] = None,
                 partial: bool = False, dtype: Optional[torch.dtype] = None):
        self.group = group
        self.stacks = dict(stacks)
        self.shape = torch.Size(shape)
        self.sdim = sdim
        self.partial = partial
        self._dtype = dtype

    @property
    def stacked(self) -> bool:
        return self.partial or self.sdim is not None

    @property
    def parts(self) -> List[torch.Tensor]:
        """Each model shard's tensor, in shard order."""
        g = self.group
        if not self.stacked:
            return [self.stacks[d] for d in g.devices]
        return [self.stacks[d][g.row_of[j]] for j, d in enumerate(g.devices)]

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype or next(iter(self.stacks.values())).dtype

    @property
    def device(self) -> torch.device:
        return self.group.first

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    @property
    def T(self):
        if self.ndim != 2:
            raise ValueError(f".T of a {self.ndim}-D sharded value")
        return self.transpose(0, 1)

    def __repr__(self):
        lay = "partial" if self.partial else (
            "replicated" if self.sdim is None else f"split dim {self.sdim}")
        return f"Sharded({tuple(self.shape)}, {self.dtype}, {lay}, m={self.group.m})"

    def __setitem__(self, idx, value):
        _setitem(self, idx, value)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _dispatch(func, args, kwargs or {})


class LeafView:
    """A parameter leaf as one group sees it: each operation on it gathers
    the model shards' blocks afresh (``materialize``), so that a layer
    recomputed in the backward pass gathers again rather than keeping
    every layer's gathered weights alive."""

    def __init__(self, group: Group, leaf: sharding.ShardedTensor):
        self.group = group
        self.leaf = leaf
        self.shape = leaf.shape
        self.dtype = leaf.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.group.first

    def dim(self) -> int:
        return len(self.shape)

    def _plan(self):
        """(the model-split dimension, the dimensions split over other mesh
        axes, per device: per shard row the (block, source device) pieces
        that tile its part in mesh order, and the rows of those pieces in
        the device's own slab where it holds them all), cached on the group
        per sharding and shape."""
        leaf, g = self.leaf, self.group
        key = (tuple(leaf.sharding.spec), tuple(leaf.shape))
        if key in g._plans:
            return g._plans[key]
        axes = leaf.sharding.dim_axes(leaf.ndim)
        names = list(g.mesh.axis_names)
        d_model, other = None, []
        for d, ax in enumerate(axes):
            if "model" in ax:
                if ax != ("model",):
                    raise ValueError(f"{leaf}: dimension {d} split over {ax}")
                d_model = d
            elif ax:
                other.append(d)
        if len(other) > 1:
            raise ValueError(f"{leaf}: {len(other)} dimensions split over "
                             f"the data axes")
        free = sorted({names.index(a) for d in other for a in axes[d]})
        sizes = g.mesh.devices.shape
        rows, local = {}, {}
        for dev, js in g.held.items():
            rows[dev] = []
            for j in (js if d_model is not None else js[:1]):
                pieces = []
                for combo in itertools.product(*(range(sizes[k]) for k in free)):
                    pos = list(g.positions[j])
                    for k, i in zip(free, combo):
                        pos[k] = i
                    pos = tuple(pos)
                    pieces.append((leaf.sharding.block_of(leaf.shape, pos),
                                   g.mesh.devices[pos]))
                rows[dev].append(pieces)
            own = leaf.rows.get(dev, {})
            if all(src == dev and b in own for r in rows[dev] for b, src in r):
                idx = [own[b] for r in rows[dev] for b, _ in r]
                local[dev] = None if idx == list(range(len(own))) else \
                    torch.tensor(idx, device=dev)
        plan = (d_model, other, rows, local)
        g._plans[key] = plan
        return plan

    def materialize(self) -> Sharded:
        """Each model shard's block of the leaf, gathered across the other
        mesh axes onto its device (a device's shards stacked): one index
        of the device's slab where it holds every piece, else copies.
        Under an account each shard's gather is an all-gather over the
        data axes, its gradient's way back a reduce-scatter and, where
        data groups hold copies of a piece, an all-reduce over them."""
        leaf, g = self.leaf, self.group
        d_model, other, rows, local = self._plan()
        kept = _acct.active() is not None
        stacks = {}
        for dev, rs in rows.items():
            k, n = len(rs), len(rs[0])

            def one(dev=dev, rs=rs, k=k, n=n):
                if dev in local:             # [rows x pieces, *block]
                    slab = leaf.slabs[dev]
                    flat = slab if local[dev] is None else slab.index_select(0, local[dev])
                else:
                    flat = torch.stack([leaf.slabs[src][leaf.rows[src][b]].to(dev)
                                        for r in rs for b, src in r])
                if other:                    # join the pieces along their dim
                    d = other[0]
                    t = flat.unflatten(0, (k, n)).movedim(1, d + 1).flatten(d + 1, d + 2)
                else:
                    t = flat
                return t if d_model is not None else t.squeeze(0)
            if not kept:
                stacks[dev] = one()
                continue
            srcs = [leaf.slabs[dev]] if dev in local else \
                [leaf.slabs[src] for src in {src for r in rs for _, src in r}]
            stacks[dev] = t = g.run(dev, d_model is not None, one, inputs=srcs)
            self._record(t, n, g.n_data // n, len(g.held[dev]), d_model is not None)
        return Sharded(g, stacks, leaf.shape, sdim=d_model)

    def _record(self, t, n: int, copies: int, devices: int, stacked: bool) -> None:
        """The all-gather of ``devices`` shards' blocks of ``n`` pieces each
        into ``t``; when ``t``'s gradient arrives, its reduce-scatter over
        the pieces and the all-reduce of a piece over the ``copies`` data
        groups that hold it."""
        block = (t[0] if stacked else t).numel() * t.element_size()
        piece = block // n
        _acct.record("all-gather", block, n, devices=devices)
        if t.requires_grad and (n > 1 or copies > 1):
            def arrived(grad):
                _acct.record("reduce-scatter", piece, n, devices=devices)
                _acct.record("all-reduce", piece, copies, devices=devices)
            t.register_hook(arrived)

    def __getattr__(self, name):
        return getattr(self.materialize(), name)

    def __getitem__(self, idx):
        return self.materialize()[idx]

    @property
    def T(self):
        return self.materialize().T

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _dispatch(func, args, kwargs or {})


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------
def _subst(obj, fn):
    """``obj`` (args, kwargs, lists within) with ``fn`` applied to each
    item."""
    if isinstance(obj, dict):
        return {k: _subst(v, fn) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_subst(v, fn) for v in obj]
    if isinstance(obj, tuple) and not isinstance(obj, torch.Size):
        return tuple(_subst(v, fn) for v in obj)
    return fn(obj)


def _items(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _items(v)
    elif isinstance(obj, (list, tuple)) and not isinstance(obj, torch.Size):
        for v in obj:
            yield from _items(v)
    else:
        yield obj


def _meta(x):
    if isinstance(x, Sharded):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def _materialize(a):
    return a.materialize() if isinstance(a, LeafView) else a


def _dispatch(func, args, kwargs):
    args = _subst(args, _materialize)
    kwargs = _subst(kwargs, _materialize)
    handler = _HANDLERS.get(func)
    if handler is not None:
        return handler(*args, **kwargs)
    return _generic(func, args, kwargs)


# elementwise functions (and ones acting on trailing dimensions only, as
# F.pad): a device's stacks go through as they are
_T = torch.Tensor
_ELEMENTWISE = {
    _T.__add__, _T.__radd__, _T.__sub__, _T.__rsub__, _T.__mul__, _T.__rmul__,
    _T.__truediv__, _T.__rtruediv__, _T.__neg__, _T.__invert__, _T.__and__,
    _T.__or__, _T.__lt__, _T.__le__, _T.__gt__, _T.__ge__, _T.__eq__, _T.__ne__,
    _T.__pow__, _T.__rpow__, _T.add, _T.sub, _T.mul, _T.div,
    torch.add, torch.sub, torch.mul, torch.div, torch.neg,
    torch.sigmoid, _T.sigmoid, torch.exp, _T.exp, torch.log, _T.log,
    torch.sqrt, _T.sqrt, torch.rsqrt, _T.rsqrt, torch.tanh, _T.tanh,
    torch.abs, _T.abs, torch.square, _T.square, _T.pow, torch.pow,
    torch.clamp, _T.clamp, _T.clamp_min, torch.clamp_min, torch.maximum,
    torch.minimum, torch.where, _T.masked_fill, torch.masked_fill,
    F.gelu, F.silu, F.softplus, F.relu, torch.relu, F.logsigmoid,
    _T.to, _T.float, _T.double, _T.half, _T.bfloat16, _T.long, _T.int,
    _T.bool, _T.contiguous, _T.type_as, _T.clone, torch.clone, _T.detach,
    torch.zeros_like, torch.ones_like, torch.empty_like, torch.full_like,
    F.pad,
}


def _sh(d):
    """A dimension index of a stacked operand: non-negative ones move past
    the stack axis."""
    return d + 1 if d >= 0 else d


def _sh_any(d):
    if isinstance(d, (tuple, list)):
        return type(d)(_sh(x) for x in d)
    return _sh(d)


def _dim_at(pos, default=None, name="dim"):
    """A rule shifting the dimension argument at ``pos`` (or ``name``)."""
    def rule(args, kwargs):
        args, kwargs = list(args), dict(kwargs)
        if name in kwargs:
            if kwargs[name] is None:
                raise ValueError("a reduction over every dimension of a "
                                 "model-split value")
            kwargs[name] = _sh_any(kwargs[name])
        elif len(args) > pos and not isinstance(args[pos], torch.Tensor):
            if args[pos] is None:
                raise ValueError("a reduction over every dimension of a "
                                 "model-split value")
            args[pos] = _sh_any(args[pos])
        elif default is not None:
            kwargs[name] = _sh(default)
        else:
            raise ValueError("a reduction over every dimension of a "
                             "model-split value")
        return args, kwargs
    return rule


def _two_dims(args, kwargs):
    args = list(args)
    args[1], args[2] = _sh(args[1]), _sh(args[2])
    return args, kwargs


def _flatten_rule(args, kwargs):
    args, kwargs = list(args), dict(kwargs)
    start = args[1] if len(args) > 1 else kwargs.pop("start_dim", 0)
    end = args[2] if len(args) > 2 else kwargs.pop("end_dim", -1)
    return [args[0], _sh(start), _sh(end)], kwargs


def _getitem_rule(args, kwargs):
    x, idx = args
    if not isinstance(idx, tuple):
        idx = (idx,)
    if idx and idx[0] is Ellipsis:
        return [x, idx], kwargs
    return [x, (slice(None),) + idx], kwargs


def _permute_rule(args, kwargs):
    dims = args[1] if len(args) == 2 and isinstance(args[1], (tuple, list)) \
        else args[1:]
    return [args[0], (0,) + tuple(_sh(d) for d in dims)], kwargs


_DIM_RULES = {}
for _f in (torch.softmax, _T.softmax, F.softmax, torch.log_softmax,
           _T.log_softmax, F.log_softmax, torch.amax, _T.amax, torch.amin,
           _T.amin, torch.sum, _T.sum, torch.mean, _T.mean, torch.var, _T.var,
           torch.std, _T.std, torch.cumsum, _T.cumsum, torch.cumprod,
           _T.cumprod, torch.logsumexp, _T.logsumexp, torch.unsqueeze,
           _T.unsqueeze, torch.squeeze, _T.squeeze, torch.narrow, _T.narrow,
           torch.index_select, _T.index_select, torch.max, _T.max, torch.min,
           _T.min, torch.flip, _T.flip, torch.unflatten, _T.unflatten,
           torch.cummax, _T.cummax):
    _DIM_RULES[_f] = _dim_at(1, name="dims" if _f in (torch.flip, _T.flip)
                             else "dim")
for _f in (torch.cat, torch.concat, torch.stack):
    _DIM_RULES[_f] = _dim_at(1, default=0)
for _f in (torch.repeat_interleave, _T.repeat_interleave):
    _DIM_RULES[_f] = _dim_at(2)
for _f in (torch.transpose, _T.transpose, torch.swapaxes, _T.swapaxes,
           torch.movedim, _T.movedim):
    _DIM_RULES[_f] = _two_dims
for _f in (torch.flatten, _T.flatten):
    _DIM_RULES[_f] = _flatten_rule
_DIM_RULES[_T.__getitem__] = _getitem_rule
_DIM_RULES[_T.permute] = _permute_rule
_DIM_RULES[torch.permute] = _permute_rule
# the dimension these take may be the split one only where the result
# keeps it whole (checked against the global shape)
_KEEPS_SHAPE = {torch.softmax, _T.softmax, F.softmax, torch.log_softmax,
                _T.log_softmax, F.log_softmax, torch.cumsum, _T.cumsum,
                torch.cumprod, _T.cumprod, torch.flip, _T.flip, torch.cummax,
                _T.cummax}


def _partial_grad(group, t) -> None:
    """Under an account: ``t``, replicated, is broadcast into the model
    shards' stacks, so its gradient arrives as the shards' partial sums,
    an all-reduce over the group (recorded once a tensor, when it
    arrives)."""
    if _acct.active() is None or not isinstance(t, torch.Tensor) \
            or not t.requires_grad or getattr(t, "_acct_partial", False):
        return
    t._acct_partial = True
    nbytes, m = t.numel() * t.element_size(), group.m
    t.register_hook(lambda g: _acct.record("all-reduce", nbytes, m, devices=m))


def _local_arg(a, dev, group, r, n_global, rank):
    """``a`` as a device's operand: a split value's stack; a replicated
    value or plain tensor whole along the aligned split dimension as its
    split view; else as it is on ``dev`` (broadcast over the stack)."""
    if isinstance(a, Sharded):
        if a.stacked:
            t = a.stacks[dev]
            return t.reshape(t.shape[:1] + (1,) * (rank - a.ndim) + t.shape[1:]) \
                if a.ndim < rank else t
        t = a.stacks[dev]
    elif isinstance(a, torch.Tensor):
        t = a if a.device == dev else a.to(dev)
    else:
        return a
    if r is not None and t.dim() >= -r and t.shape[r] == n_global:
        v = group.split_view(t, t.dim() + r, dev)
        return v.reshape(v.shape[:1] + (1,) * (rank - t.dim()) + v.shape[1:]) \
            if t.dim() < rank else v
    _partial_grad(group, t)
    return t


def _bshape(shapes) -> tuple:
    """The broadcast of ``shapes`` (``torch.broadcast_shapes``, without its
    symbolic-shape machinery)."""
    n = max(len(x) for x in shapes)
    out = [1] * n
    for x in shapes:
        off = n - len(x)
        for i, v in enumerate(x):
            if v != 1:
                if out[off + i] not in (1, v):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[off + i] = v
    return tuple(out)


def _generic(func, args, kwargs):
    flat = list(_items((args, kwargs)))
    shs = [a for a in flat if isinstance(a, Sharded)]
    name = getattr(func, "__name__", str(func))
    if any(s.partial for s in shs):
        raise ValueError(f"{name} of a partial sum: constrain it first")
    group = shs[0].group
    split = [s for s in shs if s.sdim is not None]
    if not split:                       # replicated: once a device
        stacks = {dev: group.run(dev, False, func,
                                 *_subst(args, lambda a: _rep_arg(a, dev)),
                                 **_subst(kwargs, lambda a: _rep_arg(a, dev)))
                  for dev in group.held}
        first = next(iter(stacks.values()))
        if isinstance(first, torch.Tensor):
            return Sharded(group, stacks, first.shape)
        if isinstance(first, (tuple, list)) and all(
                isinstance(x, torch.Tensor) for x in first):
            return type(first)(Sharded(group, {d: s[i] for d, s in stacks.items()},
                                       first[i].shape) for i in range(len(first)))
        raise ValueError(f"{name} of a sharded value gives {type(first).__name__}")
    if name.endswith("_") and not name.endswith("__"):
        raise ValueError(f"in-place {name} on a model-split value")
    if func is _T.to and any(isinstance(a, (torch.device, str)) for a in flat[1:]):
        raise ValueError("Tensor.to(device) of a model-split value")
    src = split[0]
    r = src.sdim - src.ndim
    if any(x.sdim - x.ndim != r for x in split):
        raise ValueError(f"{name}: operands split along different "
                         f"dimensions {[x.sdim for x in split]}")
    n_global = src.shape[src.sdim]
    tensors = [t for t in flat if isinstance(t, (Sharded, torch.Tensor))]
    rank = max(t.ndim for t in tensors)
    if func in _KEEPS_SHAPE:
        d = kwargs.get("dim", kwargs.get("dims", args[1] if len(args) > 1 else None))
        for x in (d if isinstance(d, (tuple, list)) else [d]):
            if x is not None and x % src.ndim == src.sdim:
                raise ValueError(f"{name} along the model-split dimension")
    if func in _ELEMENTWISE:
        rule = None
    elif func in _DIM_RULES:
        rule = _DIM_RULES[func]
    else:
        raise ValueError(f"{name} has no rule for a model-split value")
    if rule is None and func is not F.pad:
        G = _bshape([tuple(t.shape) for t in tensors])
    else:
        with _acct.hidden():            # shape inference, not the step's work
            out_meta = func(*_subst(args, _meta), **_subst(kwargs, _meta))
        G = out_meta if not isinstance(out_meta, torch.Tensor) else tuple(out_meta.shape)
    stacks = {}
    for dev in group.held:
        def loc(x):
            return _local_arg(x, dev, group, r, n_global, rank)
        a, k = _subst(args, loc), (_subst(kwargs, loc) if kwargs else kwargs)
        if rule is not None:
            a, k = rule(a, k)
        stacks[dev] = group.run(dev, True, func, *a, **k)
    return _wrap(name, group, stacks, G)


def _rep_arg(a, dev):
    if isinstance(a, Sharded):
        return a.stacks[dev]
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return a


def _wrap(name, group, stacks, meta):
    """Stacked per-device results as a split value, its split dimension
    read off the global shape ``meta`` (a shape, or a tuple of meta
    tensors for a function giving several)."""
    if isinstance(meta, tuple) and all(isinstance(x, int) for x in meta):
        G = meta
        L = tuple(next(iter(stacks.values())).shape[1:])
        diff = [d for d in range(len(G)) if G[d] != L[d]] if len(L) == len(G) else [-1]
        if len(diff) != 1 or diff[0] < 0 or G[diff[0]] != L[diff[0]] * group.m:
            raise ValueError(f"{name} reduces or indexes the model-split "
                             f"dimension (global {G}, a shard's {L})")
        return Sharded(group, stacks, G, sdim=diff[0])
    if isinstance(meta, (tuple, list)) and meta and all(
            isinstance(x, torch.Tensor) for x in meta):
        return type(meta)(_wrap(name, group, {d: s[i] for d, s in stacks.items()},
                                tuple(meta[i].shape)) for i in range(len(meta)))
    raise ValueError(f"{name} of a sharded value gives {type(meta).__name__}")


# -- special cases ---------------------------------------------------------------
def _parse_einsum(eq: str, n: int):
    if "..." in eq or "->" not in eq or "Z" in eq:
        raise ValueError(f"einsum '{eq}': explicit output, no ellipsis, no Z")
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if len(ins) != n:
        raise ValueError(f"einsum '{eq}' with {n} operands")
    return ins, out


def _einsum(eq, *ops):
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = tuple(ops[0])
    ops = [_materialize(o) for o in ops]
    shs = [o for o in ops if isinstance(o, Sharded)]
    if not shs:
        return torch.einsum(eq, *ops)
    group = shs[0].group
    ins, out = _parse_einsum(eq, len(ops))
    if any(o.partial for o in shs):
        raise ValueError(f"einsum '{eq}' of a partial sum: constrain it first")
    letters = {ins[i][o.sdim] for i, o in enumerate(ops)
               if isinstance(o, Sharded) and o.sdim is not None}
    if len(letters) > 1:
        keep = [ins[i][o.sdim] for i, o in enumerate(ops)
                if isinstance(o, Sharded) and o.sdim is not None
                and ins[i][o.sdim] in out]
        keep = keep[0] if keep else sorted(letters)[0]
        for i, o in enumerate(ops):
            if isinstance(o, Sharded) and o.sdim is not None \
                    and ins[i][o.sdim] != keep:
                ops[i] = group.allgather(o)
        letters = {keep}
    dt = torch.result_type(*(torch.empty((), dtype=o.dtype) for o in ops)) \
        if len(ops) > 1 else ops[0].dtype
    G = []
    for c in out:
        for i, o in enumerate(ops):
            if c in ins[i]:
                G.append(o.shape[ins[i].index(c)])
                break
    if not letters:
        return Sharded(group, {dev: group.run(dev, False, torch.einsum, eq,
                                              *[_rep_arg(o, dev) for o in ops])
                               for dev in group.held}, G)
    (c,) = letters
    partial = c not in out
    wide = _wide(dt)

    def one(dev):
        loc, subs = [], []
        for i, o in enumerate(ops):
            if isinstance(o, Sharded) and o.sdim is not None:
                t, s = o.stacks[dev], "Z" + ins[i]
            else:
                t, s = _rep_arg(o, dev), ins[i]
                if c in s:
                    t, s = group.split_view(t, s.index(c), dev), "Z" + s
                else:
                    _partial_grad(group, t)
            loc.append(t.to(wide) if partial else t)
            subs.append(s)
        return torch.einsum(",".join(subs) + "->Z" + out, *loc)
    stacks = {dev: group.run(dev, True, one, dev, inputs=[
        o.stacks[dev] if isinstance(o, Sharded) else o for o in ops])
        for dev in group.held}
    if partial:
        return Sharded(group, stacks, G, partial=True, dtype=dt)
    return Sharded(group, stacks, G, sdim=out.index(c))


_LETTERS = "abcdefghijklmnopqrstuvwxy"

def _matmul(a, b):
    a, b = _materialize(a), _materialize(b)
    if b.ndim != 2 or a.ndim < 1:
        raise ValueError("a sharded matmul takes a 2-D right operand")
    la = _LETTERS[:a.ndim]
    return _einsum(f"{la},{la[-1]}z->{la[:-1]}z", a, b)


def _logsumexp(x, dim, keepdim=False):
    x = _materialize(x)
    if not isinstance(x, Sharded) or x.sdim is None or dim % x.ndim != x.sdim \
            or keepdim or x.partial:
        return _generic(torch.logsumexp, (x, dim), {"keepdim": keepdim})
    g = x.group
    per_dev = [g.run(d, True, lambda s: torch.logsumexp(
        torch.logsumexp(s, dim=x.sdim + 1), dim=0), s) for d, s in x.stacks.items()]
    dev = next(iter(x.stacks))
    total = per_dev[0] if len(per_dev) == 1 else g.run(
        dev, True, lambda: torch.logsumexp(torch.stack([t.to(dev) for t in per_dev]),
                                           dim=0), inputs=per_dev)
    _acct.record("all-reduce", total.numel() * total.element_size(), g.m, devices=g.m)
    return g.replicate(total)


def _gather(x, dim, index, *, sparse_grad=False):
    x = _materialize(x)
    if not isinstance(x, Sharded) or x.sdim is None or dim % x.ndim != x.sdim \
            or x.partial:
        return _generic(torch.gather, (x, dim, index), {})
    g = x.group
    n = x.shape[x.sdim] // g.m
    if isinstance(index, Sharded):
        if index.stacked:
            raise ValueError("gather with a model-split index")
        index = next(iter(index.stacks.values()))

    def one(dev, s):
        offs = torch.tensor(g.held[dev], device=dev) * n
        idx = index.to(dev)[None] - offs.reshape((-1,) + (1,) * index.dim())
        ok = (idx >= 0) & (idx < n)
        got = torch.gather(s, x.sdim + 1, idx.clamp(0, n - 1))
        return torch.where(ok, got, torch.zeros((), dtype=got.dtype, device=dev))
    stacks = {dev: g.run(dev, True, one, dev, s, inputs=[s])
              for dev, s in x.stacks.items()}
    return g.reduce(Sharded(g, stacks, index.shape, partial=True, dtype=x.dtype))


def _reshape(x, *shape):
    """A reshape that keeps every dimension before the model-split one and
    splits or merges that one with the ones after it (its size still a
    multiple of the shard count): each shard reshapes its block."""
    x = _materialize(x)
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    if not isinstance(x, Sharded) or x.sdim is None or x.partial:
        return _generic(_T.reshape, (x, shape), {})
    shape = list(shape)
    if -1 in shape:
        shape[shape.index(-1)] = x.shape.numel() // -math.prod(shape)
    g, d = x.group, x.sdim
    if tuple(shape[:d]) != tuple(x.shape[:d]) or len(shape) <= d \
            or shape[d] % g.m:
        raise ValueError(f"reshape of a model-split value (split dim {d} of "
                         f"{tuple(x.shape)}) to {tuple(shape)}")
    loc = list(shape)
    loc[d] //= g.m
    return Sharded(g, {dev: g.run(dev, True, s.reshape, (s.shape[0],) + tuple(loc),
                                  inputs=[s])
                       for dev, s in x.stacks.items()}, shape, sdim=d)


def _new_zeros(x, size, *, dtype=None, device=None, **kw):
    """Zeros of ``size``, replicated (on each device of the group)."""
    x = _materialize(x)
    g = x.group
    size = tuple(size)
    return Sharded(g, {dev: g.run(dev, False, torch.zeros, size,
                                  dtype=dtype or x.dtype, device=dev)
                       for dev in g.held}, size)


def _setitem(x: "Sharded", idx, value) -> None:
    """``x[idx] = value`` in place.  Replicated: on each device's copy.
    Split: where ``idx`` (slices) keeps the split dimension whole, each
    shard writes its block; where it takes a range of it (a write into a
    sequence-split cache), each shard that holds part of the range writes
    that part, the others nothing."""
    if x.partial:
        raise ValueError("a write into a partial sum")
    g = x.group
    if not x.stacked:
        if isinstance(value, Sharded):
            value = g.relayout(value, None)
        for dev, t in x.stacks.items():
            g.run(dev, False, t.__setitem__, idx, _rep_arg(value, dev))
        return
    idx = idx if isinstance(idx, tuple) else (idx,)
    if any(not isinstance(e, slice) for e in idx):
        raise ValueError(f"a write into a model-split value at {idx}: slices only")
    d = x.sdim
    e = idx[d] if d < len(idx) else slice(None)
    if e == slice(None):
        if not isinstance(value, Sharded):
            value = g.replicate(value)
        value = g.relayout(value, d)
        for dev, t in x.stacks.items():
            g.run(dev, True, t.__setitem__, (slice(None),) + idx, value.stacks[dev])
        return
    a, b, step = e.indices(x.shape[d])
    if step != 1:
        raise ValueError(f"a strided write along the model-split dimension ({e})")
    if isinstance(value, Sharded):
        value = g.relayout(value, None)
    n = x.shape[d] // g.m
    for dev, js in g.held.items():
        v = _rep_arg(value, dev)
        for r, j in enumerate(js):
            lo, hi = max(a, j * n), min(b, (j + 1) * n)
            if lo < hi:
                loc = list(idx) + [slice(None)] * (d + 1 - len(idx))
                loc[d] = slice(lo - j * n, hi - j * n)
                g.run(dev, True, x.stacks[dev][r].__setitem__, tuple(loc),
                      v.narrow(d, lo - a, hi - lo))


_HANDLERS = {
    torch.einsum: _einsum,
    torch.matmul: _matmul,
    _T.matmul: _matmul,
    _T.__matmul__: _matmul,
    _T.__rmatmul__: lambda b, a: _matmul(a, b),
    torch.logsumexp: _logsumexp,
    _T.logsumexp: _logsumexp,
    torch.gather: _gather,
    _T.gather: _gather,
    _T.reshape: _reshape,
    torch.reshape: lambda x, shape: _reshape(x, shape),
    _T.view: _reshape,
    _T.new_zeros: _new_zeros,
}


def _method(name):
    fn = getattr(torch.Tensor, name)

    def method(self, *args, **kwargs):
        return _dispatch(fn, (self,) + args, kwargs)
    method.__name__ = name
    return method


for _name in ("to", "float", "double", "half", "bfloat16", "long", "int", "bool",
              "contiguous", "transpose", "permute", "flatten", "unflatten",
              "reshape", "view", "expand", "squeeze", "unsqueeze", "masked_fill",
              "amax", "amin", "sum", "mean", "var", "std", "max", "min",
              "clamp", "clamp_min", "exp", "log", "sqrt", "rsqrt", "sigmoid",
              "tanh", "abs", "square", "pow", "softmax", "logsumexp", "type_as",
              "flip", "narrow", "detach", "clone", "t", "matmul", "gather",
              "new_zeros", "index_add",
              "__getitem__", "__add__", "__radd__", "__sub__", "__rsub__",
              "__mul__", "__rmul__", "__truediv__", "__rtruediv__", "__neg__",
              "__invert__", "__and__", "__or__", "__lt__", "__le__", "__gt__",
              "__ge__", "__matmul__", "__rmatmul__", "__pow__", "__rpow__"):
    setattr(Sharded, _name, _method(_name))


def local(fn):
    """``fn`` applied shard by shard where an argument is sharded (for a
    function whose output has its first split input's shape and layout and
    that does not mix elements across the split dimension: K6 and its
    plain version, one launch a model shard on its slice), else ``fn``
    itself."""
    def run(*args):
        args = tuple(_materialize(a) for a in args)
        shs = [a for a in args if isinstance(a, Sharded)]
        if not shs:
            return fn(*args)
        g = shs[0].group
        split = [s for s in shs if s.sdim is not None]
        if any(s.partial for s in shs) or len({s.sdim - s.ndim for s in split}) > 1:
            raise ValueError(f"{fn}: operands in different layouts")
        if not split:
            return Sharded(g, {dev: g.run(dev, False, fn, *(_rep_arg(a, dev) for a in args))
                               for dev in g.held}, shs[0].shape)
        like = split[0]
        stacks = {}
        for dev, js in g.held.items():
            rows = [a.stacks[dev].unbind(0) if isinstance(a, Sharded) and a.stacked
                    else None for a in args]
            outs = [g.run(dev, True, fn, *(r[i] if r is not None else _rep_arg(a, dev)
                                           for a, r in zip(args, rows)))
                    for i in range(len(js))]
            stacks[dev] = g.run(dev, True, torch.stack, outs)
        shape = list(stacks[g.first].shape[1:])
        d = len(shape) + (like.sdim - like.ndim)
        shape[d] *= g.m
        return Sharded(g, stacks, shape, sdim=d)
    return run
