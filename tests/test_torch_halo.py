"""The port's ``core/halo.py`` against the JAX package's: every case of
``tests/test_halo_spec.py`` (and a 3-D, two-axis one), as parametrised
cases, each aspect of the geometry compared object for object: the
fields, every slab, the step regions, the deep interior and the bands,
the window's groups, the collective bytes, the transpose and the
errors."""
import dataclasses

import pytest

from repro.core import halo as jhalo
from repro_torch.core import halo

HALOS = {"u": (1, 1), "v": (1, 1), "c": (0, 0)}
SWAP = ("v", "u")

# (halos, grid_axes, interior, mesh shape, depth, swap): the builds of
# tests/test_halo_spec.py, then a 3-D acoustic-like one over two axes
CASES = {
    "depth1": (HALOS, ("data", None), (16, 12), {"data": 4}, 1, SWAP),
    "depth2": (HALOS, ("data", None), (16, 12), {"data": 4}, 2, SWAP),
    "depth3": (HALOS, ("data", None), (16, 12), {"data": 4}, 3, SWAP),
    "depth4": (HALOS, ("data", None), (16, 12), {"data": 4}, 4, SWAP),
    "wide_grid": ({"u": (2, 2), "v": (2, 2), "w": (1, 0)}, ("data", None),
                  (32, 8), {"data": 4}, 2, ("v", "u")),
    "solo": (HALOS, ("data", None), (16, 12), {"data": 1}, 2, SWAP),
    "two_axes": ({"u": (1, 1), "v": (1, 1)}, ("r", "c"), (8, 8),
                 {"r": 2, "c": 2}, 1, SWAP),
    "mesh2": (HALOS, ("data", None), (16, 12), {"data": 2}, 2, SWAP),
    "mesh8": (HALOS, ("data", None), (16, 12), {"data": 8}, 1, SWAP),
    "no_swap": (HALOS, ("data", None), (16, 12), {"data": 4}, 1, None),
    "acoustic3d": ({"p0": (0, 0, 0), "p1": (4, 4, 4), "vp2": (0, 0, 0),
                    "damp": (0, 0, 0)}, ("data", "model", None), (48, 32, 24),
                   {"data": 4, "model": 2}, 3, ("p0", "p1")),
}

ERRORS = {
    "indivisible": (HALOS, ("data", None), (18, 12), {"data": 4}, 1, SWAP),
    "too_deep": (HALOS, ("data", None), (16, 12), {"data": 4}, 5, SWAP),
    "depth_without_swap": (HALOS, ("data", None), (16, 12), {"data": 4}, 2, None),
    "depth_without_halo": ({"u": (0, 0), "v": (0, 0)}, ("data", None), (16, 12),
                           {"data": 4}, 2, SWAP),
    "unknown_axis": (HALOS, ("model", None), (16, 12), {"data": 4}, 1, SWAP),
    "bad_swap": (HALOS, ("data", None), (16, 12), {"data": 4}, 1, ("v", "nope")),
    "axes_arity": (HALOS, ("data",), (16, 12), {"data": 4}, 1, SWAP),
    "zero_depth": (HALOS, ("data", None), (16, 12), {"data": 4}, 0, SWAP),
}


def _pair(case):
    halos, axes, shape, mesh, depth, swap = CASES[case]
    return (halo.HaloSpec.build(halos, axes, shape, mesh, depth=depth, swap=swap),
            jhalo.HaloSpec.build(halos, axes, shape, mesh, depth=depth, swap=swap))


def _slabs(exs):
    return [dataclasses.astuple(e) + (e.elems, e.source_area()) for e in exs]


def _fields(s):
    return (dataclasses.astuple(s), s.grids, s.ndim, s.decomposed_axes(),
            [s.exchanged(a) for a in range(s.ndim)],
            [s.mesh_size(m) for m in s.grid_axes],
            {g: (s.halo_of(g), s.ext_of(g), s.padded_shape(g), s.zero_widths(g))
             for g in s.grids})


def _regions(s):
    return [s.step_region(i) for i in range(s.depth)]


def _bands(s):
    return (s.deep_interior(), s.boundary_bands(), s.overlap_feasible())


def _groups(s):
    return [s.group_depths(w) for w in range(1, 13)]


def _bytes(s):
    out = [s.exchange_bytes(it) for it in (2, 4, 8)]
    out += [s.exchange_bytes(4, [g]) for g in s.grids]
    if s.swap is not None:
        out += [s.window_collective_bytes(w, it, batch=b) for w in range(1, 11)
                for it in (2, 4) for b in (1, 3)]
    return out


def _transpose(s):
    t = s.transpose()
    return (dataclasses.astuple(t), _slabs(t.exchanges()),
            t.transpose() == s, [dataclasses.astuple(t.with_depth(d))
                                 for d in range(1, s.depth + 1)])


ASPECTS = {
    "fields": _fields,
    "slabs": lambda s: [_slabs(s.exchanges())]
    + [_slabs(s.exchanges([g])) for g in s.grids],
    "regions": _regions,
    "bands": _bands,
    "groups": _groups,
    "bytes": _bytes,
    "transpose": _transpose,
    "with_depth": lambda s: [dataclasses.astuple(s.with_depth(d))
                             for d in range(1, s.depth + 1)],
}


@pytest.mark.parametrize("aspect", list(ASPECTS))
@pytest.mark.parametrize("case", list(CASES))
def test_halo_spec_equals_the_jax_packages(case, aspect):
    port, ref = _pair(case)
    assert ASPECTS[aspect](port) == ASPECTS[aspect](ref)


@pytest.mark.parametrize("case", list(ERRORS))
def test_same_errors(case):
    halos, axes, shape, mesh, depth, swap = ERRORS[case]
    with pytest.raises(ValueError) as want:
        jhalo.HaloSpec.build(halos, axes, shape, mesh, depth=depth, swap=swap)
    with pytest.raises(ValueError) as got:
        halo.HaloSpec.build(halos, axes, shape, mesh, depth=depth, swap=swap)
    assert str(got.value) == str(want.value)


def test_step_region_and_group_errors():
    port, ref = _pair("depth3")
    for s in (port, ref):
        with pytest.raises(ValueError, match="outside depth"):
            s.step_region(3)
        with pytest.raises(ValueError, match="window must be >= 1"):
            s.group_depths(0)


def test_halo_exchange_nbytes_and_involution():
    port, _ = _pair("depth2")
    e = port.exchanges(["v"])[0]
    assert e.nbytes(4) == e.elems * 4 and e.nbytes(4, batch=3) == 3 * e.elems * 4
    assert port.transpose().transpose() == port
    assert port.transpose().with_depth(1).reverse
