"""Distributed stencil runtime: domain decomposition over a mesh of shards
and halo exchange (the counterpart of the JAX package's
``core/distributed.py``).

Design
------
* The stencil grid's axes are mapped onto mesh axes (``backend.grid_axes``,
  e.g. ``("data", "model", None)`` splits axes 0 and 1 of a 3-D domain
  over a ``(data, model)`` mesh, ``launch/mesh.py``).  One process drives
  every shard, as one program drives every device of the JAX package's
  ``shard_map``: a shard is a set of tensors on its mesh device, its local
  interior block padded per grid by the exchange widths.
* A halo exchange is a round of slab copies between the shards' tensors
  (the JAX layer's ``lax.ppermute``), axis by axis: a slab on a later axis
  covers the already padded extent of the earlier ones, so corners travel
  too.  The geometry, every slab's offset, shape and source, is
  ``core.halo.HaloSpec``'s; its bytes are ``window_collective_bytes``.
  Cells beyond the global boundary hold zeros (the global zero grid halo):
  buffers are allocated zeroed, a kernel writes there only on the shells of
  a depth-k group, and edge shards zero those cells again after such a
  step (``zero_outside_global``).  On the card the copies run on a stream
  of their own; the compute stream waits on their events before it reads a
  slab, and the copy stream waits on the compute stream before it reads an
  edge.
* The per-shard compute is a single-device lowering on a region of the
  shard's padded tensors: under ``inner=st.hopper(template=t)`` the
  per-application kernel of template ``t`` (``codegen.lower_hopper`` →
  ``MapPlan``: K4 gmem/f4/smem, K2's or K5's ``RT_MAP`` builds), under
  ``inner=st.torch()`` the torch lowering.  A sub-step region may reach
  beyond the local interior (the redundant shell of time skewing): the
  plan is then built on a larger "interior" with correspondingly smaller
  halos, the same tensors.
* ``overlap=True`` splits an update into a pass over the deep interior,
  which reads no exchanged cell and is enqueued while the copies run, and
  the boundary strips (bands) that wait for them.  Both write into a
  spare buffer, so every pass reads the pristine inputs (outputs alias
  inputs under the leapfrog swap) and the copies may read an edge while
  the interior is being computed.
* ``lower_distributed`` is one ``st.map`` application (scatter the global
  interiors into the shards, exchange, compute, gather); with
  ``time_steps=k`` and a ``swap`` pair it is overlapped tiling: one
  exchange of width ``(k−1)·h_max + h_g`` and ``k`` applications on
  shrinking regions.  ``lower_distributed_window`` is the fused time-loop
  window of the engine: ``window // k`` depth-``k`` exchange groups plus a
  remainder group, coefficients exchanged once a window, the state kept in
  the shards across windows (``TimeloopEngine(mesh=)``).
* The adjoint (``sharded_step``): each step's VJP runs per shard through
  the torch lowering, and the cotangents of the halo cells travel back
  along the transposed exchange (``HaloSpec.transpose()``), accumulating
  into the neighbours' edge cells; scalar cotangents sum over the shards.

Halo traffic a step a shard is ``h · (local surface)``: the collective
term shrinks relative to compute as the local volume grows.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import analysis, ir, lowering
from . import halo as _halo
from ..launch.mesh import mesh_axes
from .dsl import scalar_tensors

__all__ = ["lower_distributed", "lower_distributed_window", "sharded_step",
           "Layout", "launch_counts", "window_depth", "window_layout",
           "shard_scalars"]


def _time_block(backend) -> int:
    inner = getattr(backend, "inner", None)
    return int(getattr(inner, "time_block", 1) or 1)


def _grid_halos(kernel: ir.StencilIR) -> Dict[str, Tuple[int, ...]]:
    info = analysis.analyze(kernel)
    return {g: tuple(info.halo_per_grid.get(g, (0,) * kernel.ndim))
            for g in kernel.grid_params}


class _Streams:
    """The copy stream of each CUDA device of a mesh, and the events that
    order it against the devices' current (compute) streams.  No-ops on
    the CPU."""

    def __init__(self, devices):
        self.devices = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
        self.copy = {d: torch.cuda.Stream(d) for d in self.devices}

    def begin(self) -> None:
        """The copy streams wait for the work enqueued so far."""
        evs = [torch.cuda.current_stream(d).record_event() for d in self.devices]
        for s in self.copy.values():
            for ev in evs:
                s.wait_event(ev)

    def on_copy(self):
        """Context in which operations go on the copy streams."""
        stack = contextlib.ExitStack()
        for s in self.copy.values():
            stack.enter_context(torch.cuda.stream(s))
        return stack

    def barrier(self) -> None:
        """Between the axes of an exchange across cards: every copy stream
        waits for the others (one card: its one stream orders them)."""
        if len(self.copy) > 1:
            evs = [s.record_event() for s in self.copy.values()]
            for s in self.copy.values():
                for ev in evs:
                    s.wait_event(ev)

    def end(self) -> None:
        """The compute streams wait for the copies."""
        evs = [s.record_event() for s in self.copy.values()]
        for d in self.devices:
            for ev in evs:
                torch.cuda.current_stream(d).wait_event(ev)


class Layout:
    """The shards of one decomposition: each shard's mesh coordinate,
    device, neighbours and place in the global interior, and the padding
    ``pads[g]`` (cells a side, per axis) of its tensors of grid ``g``.  It
    owns the shards' tensors (``state``), reused call after call."""

    def __init__(self, mesh, grid_axes: Sequence[Optional[str]],
                 interior: Sequence[int], local: Sequence[int],
                 pads: Mapping[str, Sequence[int]], batch: int = 0):
        self.mesh = mesh
        self.grid_axes = tuple(grid_axes)
        used = [m for m in self.grid_axes if m]
        if len(set(used)) != len(used):
            raise ValueError(f"grid_axes {self.grid_axes} map two grid axes "
                             "to one mesh axis")
        self.interior, self.local = tuple(interior), tuple(local)
        self.ndim = len(self.local)
        self.pads = {g: tuple(int(p) for p in ps) for g, ps in pads.items()}
        self.batch = int(batch)
        names, sizes = tuple(mesh.axis_names), mesh.devices.shape
        self.coords = list(np.ndindex(*sizes))
        self.devices = [mesh.devices[c] for c in self.coords]
        self._index = {c: i for i, c in enumerate(self.coords)}
        self._sizes = sizes
        self._mpos = tuple(names.index(m) if m else None for m in self.grid_axes)
        self.streams = _Streams(self.devices)
        self._state = None

    @property
    def n(self) -> int:
        """Number of shards."""
        return len(self.coords)

    def neighbor(self, i: int, ax: int, nb: int) -> Optional[int]:
        """The shard next to shard ``i`` along grid axis ``ax`` on side
        ``nb`` (-1 lower, +1 higher); None at a global end or when the axis
        is unmapped."""
        p = self._mpos[ax]
        if p is None:
            return None
        c = list(self.coords[i])
        c[p] += nb
        if not 0 <= c[p] < self._sizes[p]:
            return None
        return self._index[tuple(c)]

    def origin(self, i: int) -> Tuple[int, ...]:
        """First global interior cell of shard ``i``'s block."""
        return tuple(0 if p is None else self.coords[i][p] * L
                     for p, L in zip(self._mpos, self.local))

    def local_idx(self, g: str) -> tuple:
        """Index of the local interior in a tensor of grid ``g`` (after the
        scenario axis)."""
        return (...,) + tuple(slice(p, p + L) for p, L in zip(self.pads[g], self.local))

    def shape(self, g: str) -> Tuple[int, ...]:
        """Shape of a shard tensor of grid ``g``."""
        lead = (self.batch,) if self.batch else ()
        return lead + tuple(L + 2 * p for L, p in zip(self.local, self.pads[g]))

    def zeros(self, g: str, dtype) -> List[torch.Tensor]:
        """New zeroed shard tensors of grid ``g``, one a shard."""
        return [torch.zeros(self.shape(g), dtype=dtype, device=d)
                for d in self.devices]

    def state(self, arrays: Mapping[str, torch.Tensor],
              spare: Optional[str] = None) -> "_State":
        """The shards' tensors for grids like ``arrays`` (allocated zeroed
        at the first call, or when a grid's type changes), with a spare
        tensor of grid ``spare`` a shard."""
        dt = {g: a.dtype for g, a in arrays.items() if g in self.pads}
        st = self._state
        if st is None or st.dtypes != dt or (spare and st.spare is None):
            st = self._state = _State(
                [dict(zip(dt, bufs)) for bufs in
                 zip(*[self.zeros(g, t) for g, t in dt.items()])],
                self.zeros(spare, dt[spare]) if spare else None, dt)
        return st

    def global_idx(self, i: int, full_shape) -> tuple:
        """Index of shard ``i``'s block in a global (grid-halo'd) tensor."""
        sp = tuple(full_shape)[-self.ndim:]
        o = [(s - n) // 2 for s, n in zip(sp, self.interior)]
        return (...,) + tuple(slice(oo + b, oo + b + L) for oo, b, L in
                              zip(o, self.origin(i), self.local))

    def scatter(self, bufs: List[Dict[str, torch.Tensor]],
                arrays: Mapping[str, torch.Tensor], grids) -> None:
        """Copy the global interiors of ``grids`` into the shards' local
        interiors (the grid halos of ``arrays`` are not read: the global
        halo is zero)."""
        for g in grids:
            a = arrays[g]
            li = self.local_idx(g)
            for i, b in enumerate(bufs):
                b[g][li].copy_(a[self.global_idx(i, a.shape)])

    def gather(self, bufs: List[Dict[str, torch.Tensor]],
               arrays: Dict[str, torch.Tensor], grids) -> None:
        """Copy the shards' local interiors of ``grids`` into the global
        tensors ``arrays`` (in place; their halos are left as they are)."""
        for g in grids:
            a = arrays[g]
            li = self.local_idx(g)
            for i, b in enumerate(bufs):
                a[self.global_idx(i, a.shape)].copy_(b[g][li])

    def exchange(self, bufs: List[Dict[str, torch.Tensor]],
                 exchanges: Sequence[_halo.HaloExchange]) -> None:
        """One round of ``HaloSpec.exchanges()``: each shard's slab region
        ``offset`` receives its neighbour's cells at ``offset +
        source_offset`` (a transposed spec's slabs are added in: the
        adjoint exchange).  Shards without that neighbour keep their
        zeros.  Slabs go axis by axis in the spec's order (a reversed
        order for the transpose), so a later axis's slab carries the
        corners an earlier axis brought in."""
        last = None
        for ex in exchanges:
            if last is not None and ex.axis != last:
                self.streams.barrier()
            last = ex.axis
            P = self.pads[ex.grid]
            dst = (...,) + tuple(slice(p + o, p + o + s) for p, o, s in
                                 zip(P, ex.offset, ex.size))
            src = (...,) + tuple(slice(p + o + so, p + o + so + s)
                                 for p, o, so, s in
                                 zip(P, ex.offset, ex.source_offset, ex.size))
            for i, b in enumerate(bufs):
                j = self.neighbor(i, ex.axis, ex.neighbor)
                if j is None:
                    continue
                d, s = b[ex.grid][dst], bufs[j][ex.grid][src]
                if ex.accumulate:
                    d.add_(s.to(d.device))
                else:
                    d.copy_(s)

    def outside(self, i: int, g: str) -> List[tuple]:
        """The cells of a tensor of grid ``g`` beyond the global boundary on
        shard ``i``'s mapped axes that have no neighbour there (the slabs
        ``zero_outside_global`` zeroes)."""
        out = []
        for ax, m in enumerate(self.grid_axes):
            P = self.pads[g][ax]
            if not m or P == 0:
                continue
            for nb, sl in ((-1, slice(0, P)),
                           (+1, slice(P + self.local[ax], None))):
                if self.neighbor(i, ax, nb) is None:
                    out.append((...,) + tuple(sl if a == ax else slice(None)
                                              for a in range(self.ndim)))
        return out

    def zero_outside_global(self, i: int, t: torch.Tensor, g: str) -> None:
        """Re-impose the zero grid halo beyond the global boundary on shard
        ``i``'s tensor ``t`` of grid ``g``, so shells computed there never
        leak into later steps."""
        for idx in self.outside(i, g):
            t[idx].zero_()


@dataclasses.dataclass
class _State:
    """The shards' tensors: ``bufs[i][g]`` (names rotate with the leapfrog
    swap) and a spare tensor of the written grid a shard."""
    bufs: List[Dict[str, torch.Tensor]]
    spare: Optional[List[torch.Tensor]]
    dtypes: Dict[str, torch.dtype]


def _shift(pads, local, region):
    """(halos, interior, region) of a plan on ``region`` of tensors padded
    by ``pads``: a region that reaches ``s`` cells beyond the local
    interior is a region of an interior ``s`` larger a side, its halos
    ``s`` smaller."""
    s = tuple(max(0, -b, e - L) for (b, e), L in zip(region, local))
    halos = {g: tuple(p - sa for p, sa in zip(ps, s)) for g, ps in pads.items()}
    for g, h in halos.items():
        if min(h) < 0:
            raise ValueError(f"grid '{g}' padding {pads[g]} does not cover "
                             f"the region {region}")
    return (halos, tuple(L + 2 * sa for L, sa in zip(local, s)),
            tuple((b + sa, e + sa) for (b, e), sa in zip(region, s)))


class _RegionOp:
    """One application of the kernel on ``region`` (local interior
    coordinates) of a shard's tensors: ``inner``'s per-application
    lowering, K4's ``MapPlan`` under hopper (one launch a scenario), the
    torch lowering under torch.  ``op(bufs, scal, out=None)`` writes the
    outputs' region in place, or into ``out`` (tensors of the grids'
    shapes), reading the grids only."""

    def __init__(self, kernel, pads, local, region, inner, batch: int = 0):
        halos, interior, reg = _shift(pads, local, region)
        self.region, self.batch = tuple(region), int(batch)
        self.plan = None
        if inner.kind == "hopper":
            from repro_torch.kernels.stencil import codegen as _codegen
            self.plan = _codegen.lower_hopper(
                kernel, halos, interior, reg,
                dataclasses.replace(inner, time_block=1))
        elif inner.kind == "torch":
            self._fn = lowering.lower_torch(kernel, halos, interior, reg, batch)
        else:
            raise ValueError(f"distributed: unsupported inner backend "
                             f"{inner.kind!r}")

    def __call__(self, bufs, scal, out=None):
        if self.plan is None:
            self._fn(bufs, scal, out)
            return
        if not self.batch:
            self.plan.apply(bufs, scal, out)
            return
        for b in range(self.batch):              # K4 has no scenario axis
            self.plan.apply({g: t[b] for g, t in bufs.items()}, scal[b],
                            None if out is None else {g: t[b] for g, t in out.items()})


def shard_scalars(inner_kind: str, scalars: Mapping[str, object], device,
                  batch: int = 0):
    """The scalars as a shard's pass takes them: for the torch lowering
    0-d (batched: ``(B,)``) tensors on ``device`` (a floating tensor keeps
    its type, so the f64 adjoint is not rounded); for the kernels f32
    floats (batched: a list of one dict a scenario)."""
    if inner_kind == "torch":
        if all(isinstance(v, torch.Tensor) and v.is_floating_point()
               for v in scalars.values()):
            return {n: (v.reshape(-1).expand(batch) if batch else v).to(device)
                    for n, v in scalars.items()}
        return scalar_tensors(scalars, device, batch)
    if not batch:
        return {n: float(np.float32(float(v))) for n, v in scalars.items()}
    cols = scalar_tensors(scalars, "cpu", batch)
    return [{n: float(v[b]) for n, v in cols.items()} for b in range(batch)]


def _on(scal, device):
    """A shard's copy of normalized scalars (tensors moved to its
    device)."""
    if isinstance(scal, dict):
        return {n: (v.to(device) if isinstance(v, torch.Tensor) else v)
                for n, v in scal.items()}
    return scal


def _strips(gh, grid_axes, local):
    """(deep interior, boundary strips) of one per-application update: the
    strips are the ``h``-wide slabs at both ends of each decomposed axis
    (``h`` its widest grid halo), spanning the other axes; the deep
    interior is the rest, None when empty."""
    ndim = len(local)
    full = tuple((0, L) for L in local)
    strips, deep = [], list(full)
    for ax, m in enumerate(grid_axes):
        h = max(hs[ax] for hs in gh.values())
        if m is None or h == 0:
            continue
        strips.append(tuple((0, h) if a == ax else full[a] for a in range(ndim)))
        strips.append(tuple((local[ax] - h, local[ax]) if a == ax else full[a]
                            for a in range(ndim)))
        deep[ax] = (h, local[ax] - h)
    deep = tuple(deep) if all(b < e for b, e in deep) else None
    return deep, strips


def lower_distributed(kernel: ir.StencilIR,
                      halos: Mapping[str, Tuple[int, ...]],
                      interior_shape: Tuple[int, ...],
                      region,
                      backend,
                      mesh):
    """Build ``fn(arrays, scalars) -> arrays``: one application of the
    kernel domain-decomposed over ``mesh`` (``st.map`` under
    ``st.distributed``), writing the output grids' interiors in place.

    Constraints, as in the JAX package: ``region`` must be None (express a
    PML through coefficient masks, ``regions.py``) and the global grid halo
    is zero.  ``fn.spec`` is the exchange geometry, ``fn.plans()`` the
    kernels' plans under a hopper ``inner``.  With ``backend.time_steps >
    1`` (or an inner ``time_block``) and a ``swap`` pair this is time
    skewing (``_lower_time_skewed``), which returns both swap grids after
    the steps' rotations.
    """
    del halos
    if mesh is None:
        raise ValueError("distributed backend requires launch(mesh=...)")
    if region is not None:
        raise ValueError("distributed backend updates the whole domain; "
                         "express PML via coefficient masks (regions.py)")
    info = analysis.analyze(kernel)
    grid_axes = tuple(backend.grid_axes)
    gh = _grid_halos(kernel)
    # geometry + validation (divisibility, axis mapping) via HaloSpec
    spec = _halo.HaloSpec.build(gh, grid_axes, interior_shape,
                                mesh_axes(mesh), depth=1)
    local = spec.local_shape
    if (backend.time_steps > 1
            or (_time_block(backend) > 1 and backend.swap is not None)):
        return _lower_time_skewed(kernel, interior_shape, backend, mesh)
    layout = Layout(mesh, grid_axes, interior_shape, local, gh)
    inner = backend.inner
    out_grids = info.output_grids
    opnd = tuple(g for g in kernel.grid_params
                 if g in set(info.input_grids) | set(out_grids))
    deep, strips = _strips(gh, grid_axes, local)
    overlap = bool(backend.overlap) and bool(strips)
    if overlap:
        ops = ([_RegionOp(kernel, gh, local, deep, inner)] if deep else []) \
            + [_RegionOp(kernel, gh, local, r, inner) for r in strips]
    else:
        ops = [_RegionOp(kernel, gh, local, tuple((0, L) for L in local), inner)]
    exchanges = spec.exchanges()
    spares = {}

    def fn(arrays: Dict[str, torch.Tensor], scalars: Mapping[str, object]):
        st = layout.state({g: arrays[g] for g in opnd})
        bufs = st.bufs
        layout.scatter(bufs, arrays, opnd)
        scal = [_on(shard_scalars(inner.kind, scalars, d), d)
                for d in layout.devices]
        S = layout.streams
        S.begin()
        with S.on_copy():
            layout.exchange(bufs, exchanges)
        if overlap:
            key = tuple((g, arrays[g].dtype) for g in out_grids)
            if key not in spares:
                spares[key] = [dict(zip(out_grids, z)) for z in
                               zip(*[layout.zeros(g, arrays[g].dtype)
                                     for g in out_grids])]
            outs = spares[key]
            # the deep interior reads no slab: enqueued while they copy
            n_deep = 1 if deep else 0
            for op in ops[:n_deep]:
                for i, b in enumerate(bufs):
                    op(b, scal[i], outs[i])
            S.end()
            for op in ops[n_deep:]:
                for i, b in enumerate(bufs):
                    op(b, scal[i], outs[i])
            layout.gather(outs, arrays, out_grids)
        else:
            S.end()
            for i, b in enumerate(bufs):
                ops[0](b, scal[i])
            layout.gather(bufs, arrays, out_grids)
        return arrays

    fn.mesh, fn.local_shape, fn.spec, fn.layout = mesh, local, spec, layout
    fn.plans = lambda: [op.plan for op in ops if op.plan is not None]
    return fn


# ---------------------------------------------------------------------------
# overlapped tiling / time skewing (paper §3) at mesh level
# ---------------------------------------------------------------------------
def _lower_time_skewed(kernel, interior_shape, backend, mesh):
    """k kernel applications per ONE exchange of width ext[g] = (k−1)·h_max
    + h_g: one depth-k group of the fused window (``window=k``), whose
    shells between the shrinking regions both neighbours compute and edge
    shards zero again, so the result equals k separately exchanged steps.
    A hopper ``inner`` with ``time_block=k_inner`` multiplies the depth
    (``time_steps`` counts k_inner-deep groups)."""
    swap = backend.swap
    if swap is None:
        raise ValueError("time_steps > 1 requires swap=(older, newer)")
    info = analysis.analyze(kernel)
    if len(info.output_grids) != 1 or info.output_grids[0] != swap[0]:
        raise ValueError("time skewing supports single-output kernels "
                         "writing swap[0]")
    k = backend.time_steps * _time_block(backend)
    win = lower_distributed_window(kernel, interior_shape, backend, mesh, swap, k)
    dev = win.layout.devices[0]

    def fn(arrays, scalars):
        st = win.scatter(arrays)
        win.advance(st, win.launch_scalars(scalars, dev))
        win.gather(st, arrays, swap)
        return arrays

    fn.mesh, fn.local_shape, fn.spec, fn.layout = (mesh, win.local_shape,
                                                   win.spec, win.layout)
    fn.plans = win.plans
    return fn


# ---------------------------------------------------------------------------
# the fused sharded window
# ---------------------------------------------------------------------------
def launch_counts(spec: _halo.HaloSpec, window: int, overlap: bool) -> int:
    """Per-shard passes (kernel launches a scenario under a hopper inner)
    of one fused window: a depth-d group runs d sub-steps, its first one
    split into the deep interior and ``len(boundary_bands())`` bands when
    the window overlaps."""
    use = overlap and spec.overlap_feasible()
    n = 0
    for count, d in spec.group_depths(window):
        sub = spec if d == spec.depth else spec.with_depth(d)
        n += count * (d + (len(sub.boundary_bands()) if use else 0))
    return n


def window_depth(kernel, interior, backend, mesh, swap, window: int,
                 masked: bool = False) -> int:
    """The exchange depth of a fused window of ``window`` steps: ``time_steps
    × inner time_block``, 1 for a kernel without halo and for masked
    windows, at most ``window``.  Raises ``ValueError`` for a geometry the
    mesh cannot take (``HaloSpec.build``)."""
    gh = _grid_halos(kernel)
    h_max = max((h for hs in gh.values() for h in hs), default=0)
    depth = backend.time_steps * _time_block(backend)
    if h_max == 0:
        if depth > 1:
            raise ValueError("time skewing needs a nonzero stencil halo")
        depth = 1
    if masked:
        # the freeze applies between every step, which a depth-k group's
        # shrinking regions cannot express
        depth = 1
    depth = min(depth, int(window))
    _halo.HaloSpec.build(gh, backend.grid_axes, interior, mesh_axes(mesh),
                         depth=depth, swap=swap)
    return depth


def window_layout(kernel, interior, backend, mesh, swap, depth: int,
                  batch: int = 0) -> Layout:
    """The shards of the windows of a run at exchange depth ``depth``
    (padded by that depth's ``ext``), which its shorter windows share."""
    spec = _halo.HaloSpec.build(_grid_halos(kernel), backend.grid_axes,
                                interior, mesh_axes(mesh), depth=depth,
                                swap=swap)
    return Layout(mesh, backend.grid_axes, interior, spec.local_shape,
                  dict(spec.ext), batch)


class DistributedWindow:
    """``window`` leapfrog steps of a kernel on the shards of ``layout``
    (see ``lower_distributed_window``)."""

    def __init__(self, kernel, interior, backend, mesh, swap, window,
                 batch=0, masked=False, layout: Optional[Layout] = None):
        info = analysis.analyze(kernel)
        ndim = kernel.ndim
        grid_axes = tuple(backend.grid_axes)
        if len(grid_axes) != ndim:
            raise ValueError(f"grid_axes must have {ndim} entries")
        if len(info.output_grids) != 1 or info.output_grids[0] != swap[0]:
            raise ValueError("the distributed timeloop supports single-output "
                             "kernels writing swap[0]")
        gh = _grid_halos(kernel)
        window = int(window)
        if window < 1:
            raise ValueError("window must be >= 1")
        inner = backend.inner
        if masked:
            if not batch:
                raise ValueError("masked distributed windows require batch=B "
                                 "(the serving path)")
            if inner.kind != "torch":
                raise ValueError("masked distributed windows need "
                                 "inner=st.torch() (the kernels take no mask)")
        depth = window_depth(kernel, interior, backend, mesh, swap, window, masked)
        spec = _halo.HaloSpec.build(gh, grid_axes, interior, mesh_axes(mesh),
                                    depth=depth, swap=swap)
        local = spec.local_shape
        if layout is None:
            layout = Layout(mesh, grid_axes, interior, local, dict(spec.ext), batch)
        for g, e in spec.ext:
            if any(p < w for p, w in zip(layout.pads[g], e)):
                raise ValueError(f"layout padding {layout.pads[g]} of '{g}' "
                                 f"below the exchange width {e}")
        self.kernel, self.backend, self.inner = kernel, backend, inner
        self.mesh, self.swap, self.window = mesh, tuple(swap), window
        self.batch, self.masked, self.depth = int(batch), bool(masked), depth
        self.spec, self.spec_T = spec, spec.transpose()
        self.local_shape, self.layout = local, layout
        self.groups = spec.group_depths(window)
        older, newer = swap
        self.coeffs = tuple(g for g in kernel.grid_params if g not in swap)
        self.overlap = (bool(backend.overlap) and spec.overlap_feasible()
                        and not masked)
        pads = layout.pads
        self._coeff_ex = spec.exchanges(self.coeffs)
        self._fns = {}
        if masked:
            self._masked = lowering.lower_torch_window_masked(
                kernel, pads, local, swap, 1, batch=batch)
            self._pair_ex = spec.exchanges(sorted(swap))
        else:
            for _, d in self.groups:
                sub = spec if d == spec.depth else spec.with_depth(d)
                steps = [_RegionOp(kernel, pads, local, sub.step_region(i),
                                   inner, batch) for i in range(d)]
                pre, bands = None, []
                if self.overlap:
                    pre = _RegionOp(kernel, pads, local, sub.deep_interior(),
                                    inner, batch)
                    bands = [_RegionOp(kernel, pads, local, r, inner, batch)
                             for r in sub.boundary_bands()]
                self._fns[d] = (sub, sub.exchanges(sorted(swap)), steps, pre,
                                bands)
        self.launches_per_scenario = (window if masked else
                                      launch_counts(spec, window, self.overlap)
                                      ) * layout.n

    # -- the shards' state ---------------------------------------------------
    def scatter(self, arrays: Mapping[str, torch.Tensor], grids=None) -> _State:
        """The shards' state holding ``arrays``' interiors (all grids, or
        ``grids``)."""
        st = self.layout.state(arrays, spare=self.swap[0])
        self.layout.scatter(st.bufs, arrays,
                            self.kernel.grid_params if grids is None else grids)
        return st

    def gather(self, st: _State, arrays: Dict[str, torch.Tensor], grids,
               fresh: bool = False) -> Dict[str, torch.Tensor]:
        """Write the shards' interiors of ``grids`` into ``arrays`` (in
        place, or into clones when ``fresh``); returns the dict."""
        arrays = dict(arrays)
        if fresh:
            for g in grids:
                arrays[g] = arrays[g].clone()
        self.layout.gather(st.bufs, arrays, grids)
        return arrays

    def launch_scalars(self, scalars, device):
        """``scalars`` in the form ``advance`` takes them (``shard_scalars``
        on ``device``)."""
        return shard_scalars(self.inner.kind, scalars, device, self.batch)

    def plans(self) -> list:
        """The kernels' plans this window launches (hopper inner)."""
        out = []
        for _, _, steps, pre, bands in self._fns.values():
            out += [op.plan for op in (*steps, pre, *bands)
                    if op is not None and op.plan is not None]
        return out

    # -- one window ------------------------------------------------------------
    def advance(self, st: _State, scal, mask=None, start: int = 0,
                limits=None) -> None:
        """Advance the shards' state ``window`` steps in place (the names of
        the swap pair rotate in ``st.bufs``); ``scal`` from
        ``launch_scalars``; ``mask``/``start``/``limits`` (masked
        windows): the global bool mask ``(B,) + interior``, the window's
        first step and the ``(B,)`` step budgets."""
        lay, S = self.layout, self.layout.streams
        scal = [_on(scal, d) for d in lay.devices]
        S.begin()
        with S.on_copy():
            lay.exchange(st.bufs, self._coeff_ex)
        if self.masked:
            masks = [mask[lay.global_idx(i, mask.shape)].to(d)
                     for i, d in enumerate(lay.devices)]
            for s in range(self.window):
                with S.on_copy():
                    lay.exchange(st.bufs, self._pair_ex)
                S.end()
                for i, b in enumerate(st.bufs):
                    out = self._masked(b, scal[i], masks[i], start + s,
                                       limits.to(lay.devices[i]))
                    b[self.swap[0]], b[self.swap[1]] = out[self.swap[0]], out[self.swap[1]]
                S.begin()
            return
        first = True
        for count, d in self.groups:
            for _ in range(count):
                self._group(st, scal, d, first)
                first = False

    def _group(self, st: _State, scal, d: int, first: bool) -> None:
        lay, S = self.layout, self.layout.streams
        older, newer = self.swap
        sub, pair_ex, steps, pre, bands = self._fns[d]
        if not first:
            S.begin()
        with S.on_copy():
            lay.exchange(st.bufs, pair_ex)
        for i in range(d):
            region = sub.step_region(i)
            shell = any(b < 0 for b, _ in region)
            if i == 0 and pre is not None:
                # the deep interior reads no slab: it runs while they
                # copy; it and the bands write the spare, so every pass
                # reads the pristine inputs
                for j, b in enumerate(st.bufs):
                    pre(b, scal[j], {older: st.spare[j]})
                S.end()
                for op in bands:
                    for j, b in enumerate(st.bufs):
                        op(b, scal[j], {older: st.spare[j]})
                for j, b in enumerate(st.bufs):
                    new = st.spare[j]
                    if shell:
                        lay.zero_outside_global(j, new, older)
                    st.spare[j] = b[older]
                    b[older], b[newer] = b[newer], new
                continue
            if i == 0:
                S.end()
            for j, b in enumerate(st.bufs):
                steps[i](b, scal[j])
                if shell:
                    lay.zero_outside_global(j, b[older], older)
                b[older], b[newer] = b[newer], b[older]

    def __call__(self, arrays, scal, mask=None, start=0, limits=None):
        """The window on global (grid-halo'd) tensors: scatter, advance,
        and the swap pair gathered into new tensors (the arguments are left
        as they were; the grid halos stay with their names)."""
        st = self.scatter(arrays)
        self.advance(st, scal, mask, start, limits)
        return self.gather(st, arrays, self.swap, fresh=True)


def lower_distributed_window(kernel: ir.StencilIR,
                             interior_shape: Tuple[int, ...],
                             backend,
                             mesh,
                             swap: Tuple[str, str],
                             window: int,
                             batch: int = 0,
                             masked: bool = False,
                             layout: Optional[Layout] = None
                             ) -> DistributedWindow:
    """The fused sharded window: ``window`` leapfrog steps on the shards.

    The window decomposes into depth-``k`` exchange groups (``k =
    time_steps × inner time_block``, ``HaloSpec.group_depths``): ``window
    // k`` groups plus a remainder group.  Within a group the swap pair
    exchanges ONE ``k·h_max``-wide halo, then ``k`` applications run on
    shrinking regions, each shard's in place (the names of the pair rotate
    a step).  With ``overlap`` and ``spec.overlap_feasible()`` the first
    application's deep interior (``HaloSpec.deep_interior``) runs while the
    copies do and only the bands (``HaloSpec.boundary_bands``) wait for
    them.  Coefficient grids are exchanged once a window, at the full
    depth.  Under ``inner=st.hopper(template=t)`` every pass is the
    per-application kernel of ``t`` on its region (the JAX window runs XLA
    a shard whatever the inner; the port's kernels compute the same
    function on the same regions); under ``st.torch()`` the torch
    lowering.  The shards keep their tensors padded to ``layout``'s widths
    (default: this window's ``ext``; the engine shares one layout between
    its windows), and the exchange copies into the halo slabs.

    ``batch > 0`` runs B scenarios along a leading unsharded axis; the
    kernel (which has no scenario axis) launches once a scenario.
    ``masked=True`` (batched, torch inner) is the serving variant
    ``fn(arrays, scalars, mask, start, limits)``: a depth-1 exchange and
    the freeze of ``lowering.lower_torch_window_masked`` between every
    step; masked cells travel through the exchange like any other.

    ``fn(arrays, scal)`` runs it on global tensors (``scal`` from
    ``fn.launch_scalars``); ``scatter``/``advance``/``gather`` keep the
    state in the shards across windows.  ``fn.spec`` is the geometry
    (``fn.spec_T`` its transpose, the adjoint's), ``fn.groups`` the
    schedule, ``fn.launches_per_scenario`` the passes a window launches.
    """
    if mesh is None:
        raise ValueError("distributed backend requires launch(mesh=...)")
    if swap is None:
        raise ValueError("the distributed timeloop requires "
                         "swap=(older, newer)")
    return DistributedWindow(kernel, tuple(interior_shape), backend, mesh,
                             tuple(swap), window, batch, masked, layout)


# ---------------------------------------------------------------------------
# the adjoint step: per-shard VJPs and the transposed exchange
# ---------------------------------------------------------------------------
class ShardedStep:
    """One leapfrog step of the torch lowering on the shards (depth-1
    exchange), as a function of global tensors that autograd
    differentiates through the transposed exchange (``_ShardedStepFn``).
    ``masked``: the step of the masked serving window."""

    def __init__(self, kernel, interior, grid_axes, mesh, swap, batch=0,
                 masked=False):
        gh = _grid_halos(kernel)
        self.spec = _halo.HaloSpec.build(gh, grid_axes, interior,
                                         mesh_axes(mesh), depth=1, swap=swap)
        self.layout = Layout(mesh, grid_axes, interior, self.spec.local_shape,
                             dict(self.spec.ext), batch)
        self.kernel, self.swap, self.batch = kernel, tuple(swap), int(batch)
        self.masked = masked
        local = self.spec.local_shape
        if masked:
            self._local = lowering.lower_torch_window_masked(
                kernel, self.layout.pads, local, swap, 1, batch=batch)
        else:
            self._local = lowering.lower_torch_window(
                kernel, self.layout.pads, local, None, swap, 1, batch=batch,
                fresh=True)
        self.touched = tuple(g for g in kernel.grid_params
                             if g in set(kernel.output_grids()) | set(swap))
        self._ex = self.spec.exchanges()
        self._ex_T = tuple(reversed(self.spec.transpose().exchanges()))

    def padded(self, arrays) -> List[Dict[str, torch.Tensor]]:
        """New shard tensors holding ``arrays``' interiors, exchanged."""
        lay = self.layout
        bufs = [dict(zip(arrays, z)) for z in
                zip(*[lay.zeros(g, a.dtype) for g, a in arrays.items()])]
        lay.scatter(bufs, arrays, list(arrays))
        lay.exchange(bufs, self._ex)
        return bufs

    def local(self, i, x, s, masked_args):
        """Shard ``i``'s step on its padded tensors ``x``."""
        if not self.masked:
            return self._local(x, s)
        mask, start, limits = masked_args
        lay = self.layout
        return self._local(x, s, mask[lay.global_idx(i, mask.shape)].to(lay.devices[i]),
                           start, limits.to(lay.devices[i]))

    def __call__(self, arrays, scalars, *masked_args):
        names, snames = list(arrays), list(scalars)
        outs = _ShardedStepFn.apply(self, names, snames, masked_args,
                                    *arrays.values(), *scalars.values())
        y = dict(arrays)
        y.update(zip(self.touched, outs))
        return y


class _ShardedStepFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, step, names, snames, masked_args, *tensors):
        arrays = dict(zip(names, tensors[:len(names)]))
        scal = dict(zip(snames, tensors[len(names):]))
        lay = step.layout
        bufs = step.padded(arrays)
        ys = [step.local(i, b, {n: v.to(lay.devices[i]) for n, v in scal.items()},
                         masked_args)
              for i, b in enumerate(bufs)]
        out = {g: arrays[g].clone() for g in step.touched}
        lay.gather(ys, out, step.touched)
        ctx.step, ctx.names, ctx.snames, ctx.masked_args = (step, names, snames,
                                                            masked_args)
        ctx.save_for_backward(*tensors)
        return tuple(out[g] for g in step.touched)

    @staticmethod
    def backward(ctx, *cots):
        step, names, snames = ctx.step, ctx.names, ctx.snames
        tensors = ctx.saved_tensors
        arrays = dict(zip(names, tensors[:len(names)]))
        scal = dict(zip(snames, tensors[len(names):]))
        lay = step.layout
        cot = dict(zip(step.touched, cots))
        bufs = step.padded({g: a.detach() for g, a in arrays.items()})
        d_bufs, d_scal = [], {n: None for n in snames}
        for i, b in enumerate(bufs):
            dev = lay.devices[i]
            with torch.enable_grad():
                x = {g: t.requires_grad_(t.is_floating_point()) for g, t in b.items()}
                s = {n: v.detach().to(dev).requires_grad_(v.is_floating_point())
                     for n, v in scal.items()}
                y = step.local(i, x, s, ctx.masked_args)
                outs = [g for g in step.touched if y[g].requires_grad]
                cy = []
                for g in outs:
                    c = torch.zeros_like(y[g])
                    if cot[g] is not None:
                        c[lay.local_idx(g)] = cot[g][lay.global_idx(i, cot[g].shape)].to(dev)
                    cy.append(c)
                ins = [t for t in (*x.values(), *s.values()) if t.requires_grad]
                grads = torch.autograd.grad([y[g] for g in outs], ins, cy,
                                            allow_unused=True)
            got = dict(zip(map(id, ins), grads))
            d_bufs.append({g: (got.get(id(t)) if got.get(id(t)) is not None
                               else torch.zeros_like(t)) for g, t in x.items()})
            for n, t in s.items():
                gs = got.get(id(t))
                if gs is not None:       # the shards' shares sum (psum)
                    gs = gs.to(scal[n].device)
                    d_scal[n] = gs if d_scal[n] is None else d_scal[n] + gs
        # the halo cells' cotangents travel back to the edges they came from
        lay.exchange(d_bufs, step._ex_T)
        d_in = {}
        for g, a in arrays.items():
            if not a.is_floating_point():
                d_in[g] = None
                continue
            d = torch.zeros_like(a)
            if cot.get(g) is not None:
                # a written grid's halo is its input's, passed through
                d.copy_(cot[g])
                for i in range(lay.n):
                    d[lay.global_idx(i, d.shape)] = 0
            for i, db in enumerate(d_bufs):
                d[lay.global_idx(i, d.shape)] += db[g][lay.local_idx(g)].to(d.device)
            d_in[g] = d
        return (None, None, None, None, *[d_in[g] for g in names],
                *[None if d_scal[n] is None else d_scal[n].to(scal[n].dtype)
                  for n in snames])


def sharded_step(kernel: ir.StencilIR, interior_shape, backend, mesh, swap,
                 batch: int = 0, masked: bool = False) -> ShardedStep:
    """The adjoint's step on a mesh: ``fn(arrays, scalars[, mask, start,
    limits]) -> arrays``, one leapfrog step of the torch lowering on each
    shard after a depth-1 exchange, the swap pair's interiors gathered into
    new tensors.  Its VJP runs per shard through the torch lowering, then
    the transposed exchange (``HaloSpec.transpose()``) adds each halo
    cell's cotangent into the neighbour's edge cell it was copied from;
    scalar cotangents sum over the shards."""
    return ShardedStep(kernel, tuple(interior_shape), tuple(backend.grid_axes),
                       mesh, swap, batch, masked)
