"""First-class halo-exchange geometry for the distributed stencil runtime:
the port's own copy of the JAX package's ``core/halo.py`` (pure geometry,
the same objects field for field).

``HaloSpec`` lifts the exchange bookkeeping that used to live implicitly
inside ``core/distributed.py`` — pad widths, slab shapes, shrinking
per-step compute regions, global-boundary zero fill, redundant-shell
feasibility — into a frozen, directly testable object (modeled on xdsl's
``HaloExchangeDef``: each exchanged slab carries its offset, size, source
offset and neighbor direction).

Geometry of one depth-``k`` exchange group (overlapped tiling / time
skewing, paper §3 at pod level): each shard exchanges ONE wide halo and
then computes ``k`` kernel applications on regions shrinking by ``h_max``
per step.  The slab widths are

    swap pair        k·h_max          (uniform — the pair trades buffers
                                       between steps and must share layout)
    other grids      (k−1)·h_max + h_g  (per axis: deepest shell read)

Axes mapped to a mesh axis of size 1 and unmapped axes receive *zeros*
instead of a neighbor slab — the global zero grid-halo; shards at a mesh
boundary re-impose the same zeros on the cells beyond the global edge
between fused steps (``zero widths`` here, masking in the lowering).

A fusion window of ``w`` steps decomposes into ``w // k`` full-depth
groups plus one remainder group of depth ``w mod k`` (the same split as
``timeloop.window_parts``); ``window_collective_bytes`` prices exactly
that schedule — coefficients exchanged once per window at the full
depth, the swap pair once per group at the group's own depth — the
slabs ``distributed.lower_distributed_window`` copies between shards.

``transpose()`` is the adjoint geometry: reverse-mode differentiation
turns every halo *receive* into a cotangent *send-back* — the transpose
of a slab copy to a neighbor is the copy with the neighbors swapped,
moving the same slab the opposite way, and the slab lands as an *accumulation*
into the neighbor's edge region instead of an overwrite of a halo
region.  Slab shapes (and therefore ``window_collective_bytes``) are
identical to the forward spec; only direction and destination flip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

__all__ = ["HaloExchange", "HaloSpec"]


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class HaloExchange:
    """One exchanged slab (xdsl ``HaloExchangeDef`` shape).

    ``offset`` is the slab origin in *local interior* coordinates (negative
    on the low side), ``size`` its shape in the axis-by-axis padded layout
    the lowering concatenates (axes below ``axis`` are already padded when
    this slab moves, so their extents include both halos), and
    ``source_offset`` the shift onto the neighbor's coordinates — the cells
    arrive from ``offset + source_offset`` on the ``neighbor`` side.

    ``accumulate`` marks an adjoint (transposed) exchange: the arriving
    slab is *added into* the destination region (cotangents from the
    neighbor's halo reads sum into the owning cells) instead of
    overwriting a halo region, exactly as the transpose of a gather is a
    scatter-add."""
    grid: str
    axis: int                       # grid axis being exchanged
    mesh_axis: str                  # mesh axis the neighbor lives on
    neighbor: int                   # -1: from the lower shard, +1: higher
    width: int                      # slab width along ``axis``
    size: Tuple[int, ...]
    offset: Tuple[int, ...]
    source_offset: Tuple[int, ...]
    accumulate: bool = False

    @property
    def elems(self) -> int:
        """Number of grid points in the slab (product of ``size``)."""
        return _prod(self.size)

    def nbytes(self, itemsize: int, batch: int = 1) -> int:
        """Bytes this slab moves: ``elems * itemsize``, times the scenario
        ``batch`` when the grids carry a leading batch axis (every scenario
        exchanges its own slab inside one collective)."""
        return self.elems * int(itemsize) * max(1, int(batch))

    def source_area(self) -> Tuple[Tuple[int, int], ...]:
        """(begin, end) per axis of the source region on the neighbor."""
        return tuple((o + s, o + s + sz) for o, s, sz in
                     zip(self.offset, self.source_offset, self.size))


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Exchange geometry of one depth-``k`` group of a distributed
    stencil: built once from pure geometry (no live mesh, no devices), so
    every derived quantity is directly assertable in tests."""
    halos: Tuple[Tuple[str, Tuple[int, ...]], ...]   # grid → stencil halo
    grid_axes: Tuple[Optional[str], ...]             # grid axis → mesh axis
    interior_shape: Tuple[int, ...]
    mesh_shape: Tuple[Tuple[str, int], ...]          # mesh axis → size
    depth: int                                       # k: steps per exchange
    swap: Optional[Tuple[str, str]]
    h_max: int
    local_shape: Tuple[int, ...]
    ext: Tuple[Tuple[str, Tuple[int, ...]], ...]     # grid → pad widths
    reverse: bool = False                            # adjoint direction

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, halos: Mapping[str, Sequence[int]],
              grid_axes: Sequence[Optional[str]],
              interior_shape: Sequence[int],
              mesh_shape: Mapping[str, int],
              depth: int = 1,
              swap: Optional[Tuple[str, str]] = None) -> "HaloSpec":
        """Validate and derive the geometry.  Raises ``ValueError`` for an
        indivisible decomposition, a depth the local extent cannot carry
        (k·h_max > local), or a swap pair that is not a grid."""
        grid_axes = tuple(grid_axes)
        interior_shape = tuple(int(s) for s in interior_shape)
        ndim = len(interior_shape)
        if len(grid_axes) != ndim:
            raise ValueError(f"grid_axes must have {ndim} entries "
                             f"(got {grid_axes})")
        mesh_shape = {str(a): int(n) for a, n in dict(mesh_shape).items()}
        halos = {g: tuple(int(h) for h in hs) for g, hs in halos.items()}
        depth = int(depth)
        if depth < 1:
            raise ValueError("exchange depth must be >= 1")
        for ax, m in enumerate(grid_axes):
            if m is None:
                continue
            if m not in mesh_shape:
                raise ValueError(f"grid axis {ax} maps to unknown mesh "
                                 f"axis {m!r} (mesh has {sorted(mesh_shape)})")
            if interior_shape[ax] % mesh_shape[m]:
                raise ValueError(
                    f"domain axis {ax} ({interior_shape[ax]}) not divisible "
                    f"by mesh axis '{m}' ({mesh_shape[m]})")
        local = tuple(
            s // (mesh_shape[m] if m else 1)
            for s, m in zip(interior_shape, grid_axes))
        h_max = max((h for hs in halos.values() for h in hs), default=0)
        if depth > 1:
            if swap is None:
                raise ValueError("exchange depth > 1 requires a swap pair")
            if h_max == 0:
                raise ValueError("time skewing needs a nonzero stencil halo")
        if swap is not None:
            for g in swap:
                if g not in halos:
                    raise ValueError(f"swap grid {g!r} is not a grid")
        # decomposed axes exchange (k−1)·h_max + h_g wide slabs; the swap
        # pair must share geometry (they trade buffers between steps) →
        # both get the uniform k·h_max
        ext = {g: tuple((depth - 1) * h_max + hs[ax] for ax in range(ndim))
               for g, hs in halos.items()}
        for g in (swap or ()):
            ext[g] = (depth * h_max,) * ndim
        for ax, m in enumerate(grid_axes):
            if m and depth * h_max > local[ax]:
                raise ValueError(
                    f"k·h halo ({depth}·{h_max}) exceeds local extent "
                    f"{local[ax]} on axis {ax}; reduce time_steps or the "
                    f"mesh split")
        return cls(halos=tuple(sorted(halos.items())),
                   grid_axes=grid_axes,
                   interior_shape=interior_shape,
                   mesh_shape=tuple(sorted(mesh_shape.items())),
                   depth=depth, swap=tuple(swap) if swap else None,
                   h_max=h_max, local_shape=local,
                   ext=tuple(sorted(ext.items())))

    def with_depth(self, depth: int) -> "HaloSpec":
        """Same decomposition at another temporal depth (remainder groups)."""
        sub = HaloSpec.build(dict(self.halos), self.grid_axes,
                             self.interior_shape, dict(self.mesh_shape),
                             depth=depth, swap=self.swap)
        return dataclasses.replace(sub, reverse=self.reverse)

    def transpose(self) -> "HaloSpec":
        """The adjoint exchange geometry: same grids, widths, slab shapes
        and traffic, but every slab moves the *opposite* direction and
        lands as an accumulation into the neighbor's edge region (the
        reverse slab copy that is the transpose of the forward one).
        An involution: ``spec.transpose().transpose() == spec``.

        >>> s = HaloSpec.build({"u": (1, 1), "v": (1, 1)}, ("data", None),
        ...                    (8, 8), {"data": 2}, depth=1, swap=("v", "u"))
        >>> t = s.transpose()
        >>> t.exchange_bytes(4) == s.exchange_bytes(4)
        True
        >>> t.transpose() == s
        True
        """
        return dataclasses.replace(self, reverse=not self.reverse)

    # -- mappings ----------------------------------------------------------
    @property
    def grids(self) -> Tuple[str, ...]:
        """Grid names in the spec, sorted (the ``halos`` mapping's keys)."""
        return tuple(g for g, _ in self.halos)

    @property
    def ndim(self) -> int:
        """Number of spatial axes of the decomposed domain."""
        return len(self.interior_shape)

    def halo_of(self, grid: str) -> Tuple[int, ...]:
        """Per-axis stencil halo of one grid (the ``order``-derived widths
        the kernel reads, before any depth widening)."""
        return dict(self.halos)[grid]

    def ext_of(self, grid: str) -> Tuple[int, ...]:
        """Pad/exchange width per axis for one grid at this depth."""
        return dict(self.ext)[grid]

    def mesh_size(self, name: Optional[str]) -> int:
        """Shard count along mesh axis ``name`` (1 for ``None``/unknown —
        an unmapped grid axis behaves like a single-shard split)."""
        return dict(self.mesh_shape).get(name, 1) if name else 1

    def decomposed_axes(self) -> Tuple[int, ...]:
        """Grid-axis indices mapped to a mesh axis (in axis order)."""
        return tuple(ax for ax, m in enumerate(self.grid_axes) if m)

    def exchanged(self, ax: int) -> bool:
        """True when this axis moves real neighbor slabs (mapped to a mesh
        axis of size > 1); mapped size-1 axes and unmapped axes are
        zero-filled instead (the global zero grid-halo)."""
        m = self.grid_axes[ax]
        return bool(m) and self.mesh_size(m) > 1

    def padded_shape(self, grid: str) -> Tuple[int, ...]:
        """Local shard shape of one grid after the exchange pads both sides
        of every axis with its ``ext_of`` width (what the per-shard kernel
        actually sees, minus any scenario batch axis)."""
        e = self.ext_of(grid)
        return tuple(l + 2 * w for l, w in zip(self.local_shape, e))

    # -- slabs -------------------------------------------------------------
    def exchanges(self, grids: Optional[Sequence[str]] = None
                  ) -> Tuple[HaloExchange, ...]:
        """Every slab one exchange round at this depth actually moves (both
        directions; zero-filled axes excluded).  Slab shapes follow the
        axis-by-axis pad order of the lowering: axes below the exchanged
        one are already halo-padded when its slab moves.

        On a ``reverse`` (transposed) spec each slab is the adjoint of the
        corresponding forward one: its destination is the forward slab's
        *source* region (the neighbor's edge cells whose values were read
        through the halo), its source is the forward destination (my halo
        region, now holding cotangents), the neighbor direction is
        inverted, and ``accumulate`` is set — same width, same shape,
        same bytes."""
        out = []
        for g in (grids if grids is not None else self.grids):
            e = self.ext_of(g)
            for ax in range(self.ndim):
                w = e[ax]
                if w == 0 or not self.exchanged(ax):
                    continue
                size = tuple(
                    w if a == ax
                    else (self.local_shape[a] + 2 * e[a] if a < ax
                          else self.local_shape[a])
                    for a in range(self.ndim))
                for nb in (-1, +1):
                    offset = tuple(
                        (-w if nb < 0 else self.local_shape[ax])
                        if a == ax else (-e[a] if a < ax else 0)
                        for a in range(self.ndim))
                    src = tuple(
                        (self.local_shape[ax] if nb < 0
                         else -self.local_shape[ax]) if a == ax else 0
                        for a in range(self.ndim))
                    if self.reverse:
                        # adjoint slab: land on the forward source region,
                        # pull from the forward destination, flip neighbor
                        offset = tuple(o + s for o, s in zip(offset, src))
                        src = tuple(-s for s in src)
                        nb = -nb
                    out.append(HaloExchange(
                        grid=g, axis=ax, mesh_axis=self.grid_axes[ax],
                        neighbor=nb, width=w, size=size, offset=offset,
                        source_offset=src, accumulate=self.reverse))
        return tuple(out)

    def zero_widths(self, grid: str) -> Tuple[int, ...]:
        """Per-axis width of the zero fill replacing a neighbor slab on
        axes that have no neighbor (unmapped, or mesh size 1).  Mapped
        edge shards additionally re-impose zeros of ``ext`` width beyond
        the global boundary between fused steps (masked in the lowering)."""
        e = self.ext_of(grid)
        return tuple(0 if self.exchanged(ax) else e[ax]
                     for ax in range(self.ndim))

    # -- per-step compute regions -----------------------------------------
    def step_region(self, i: int) -> Tuple[Tuple[int, int], ...]:
        """Compute region of sub-step ``i`` (0-based) of a depth-k group,
        in local interior coordinates: decomposed axes carry a redundant
        shell of (k−1−i)·h_max that shrinks to zero at the last step."""
        if not 0 <= i < self.depth:
            raise ValueError(f"step {i} outside depth {self.depth}")
        shell = (self.depth - 1 - i) * self.h_max
        return tuple(
            (-shell, self.local_shape[ax] + shell) if self.grid_axes[ax]
            else (0, self.local_shape[ax])
            for ax in range(self.ndim))

    def deep_interior(self) -> Tuple[Tuple[int, int], ...]:
        """The h_max-shrunk interior whose first-step update reads no
        exchanged cell — computable before the slab copies land (the
        overlap pre-pass)."""
        return tuple(
            (self.h_max, self.local_shape[ax] - self.h_max)
            if self.grid_axes[ax] else (0, self.local_shape[ax])
            for ax in range(self.ndim))

    def boundary_bands(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        """Step-0 regions outside the deep interior (two bands per
        decomposed axis, spanning the full step-0 extent on the others).
        Patched sequentially they exactly tile step_region(0) minus
        deep_interior() — overlapping corners recompute identical values."""
        r0 = self.step_region(0)
        bands = []
        for ax in self.decomposed_axes():
            lo = tuple((r0[a][0], self.h_max) if a == ax else r0[a]
                       for a in range(self.ndim))
            hi = tuple((self.local_shape[a] - self.h_max, r0[a][1])
                       if a == ax else r0[a] for a in range(self.ndim))
            bands.append(lo)
            bands.append(hi)
        return tuple(bands)

    def overlap_feasible(self) -> bool:
        """The pre-pass needs a nonempty deep interior on every decomposed
        axis (local > 2·h_max) and actual communication to hide — at least
        one axis moving real neighbor slabs (mesh size > 1)."""
        if self.h_max == 0 or not self.decomposed_axes():
            return False
        if not any(self.exchanged(ax) for ax in self.decomposed_axes()):
            return False
        return all(self.local_shape[ax] > 2 * self.h_max
                   for ax in self.decomposed_axes())

    # -- window schedule & traffic ----------------------------------------
    def group_depths(self, window: int) -> Tuple[Tuple[int, int], ...]:
        """(count, depth) exchange groups covering a ``window``-step fusion
        window: ``window // depth`` full groups plus one remainder group —
        the ``timeloop.window_parts`` split expressed as groups."""
        window = int(window)
        if window < 1:
            raise ValueError("window must be >= 1")
        m, r = divmod(window, self.depth)
        out = []
        if m:
            out.append((m, self.depth))
        if r:
            out.append((1, r))
        return tuple(out)

    def exchange_bytes(self, itemsize: int,
                       grids: Optional[Sequence[str]] = None,
                       batch: int = 1) -> int:
        """Bytes one exchange round at this depth moves per shard (every
        slab charged in full on every shard, as the JAX package charges a
        collective-permute)."""
        return sum(ex.nbytes(itemsize, batch)
                   for ex in self.exchanges(grids))

    def window_collective_bytes(self, window: int, itemsize: int,
                                batch: int = 1) -> int:
        """Per-shard collective bytes of one fused ``window``: coefficient
        grids are exchanged ONCE (at this spec's full depth — wide enough
        for every group); the swap pair once per group at the group's own
        depth.  Mirrors ``distributed.lower_distributed_window`` exactly."""
        sw = set(self.swap or ())
        coeffs = [g for g in self.grids if g not in sw]
        total = self.exchange_bytes(itemsize, coeffs, batch)
        for count, d in self.group_depths(window):
            sub = self if d == self.depth else self.with_depth(d)
            total += count * sub.exchange_bytes(itemsize, sorted(sw), batch)
        return total
