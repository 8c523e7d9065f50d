"""Port parity: IR, frontend and analysis of repro_torch vs the JAX package.

The port keeps its own copies of ir.py, frontend.py and analysis.py; the
same kernel source text must give the same StencilIR and StencilInfo.  The
classes differ (two packages), so they are compared as
``dataclasses.astuple``, ``repr`` and a flat token walk.  No arithmetic: exact equality.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import acoustic as jacoustic  # noqa: E402
from repro.core import suite as jsuite  # noqa: E402
from repro_torch.core import acoustic, analysis, frontend, ir, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402


def _pairs():
    for name in suite.KERNEL_NAMES:
        yield name, jsuite.get_kernel(name), suite.get_kernel(name)
    yield ("acoustic_iso_kernel", jacoustic.acoustic_iso_kernel,
           acoustic.acoustic_iso_kernel)


PAIRS = {name: (j, t) for name, j, t in _pairs()}


def _tokens(obj):
    """Pre-order (class name, leaf) tokens of an IR value, walked with an
    explicit stack: box3d4r's 729-tap expression nests too deep for the
    recursive ``astuple``/``repr``."""
    out, stack = [], [obj]
    while stack:
        x = stack.pop()
        if dataclasses.is_dataclass(x):
            out.append(type(x).__name__)
            stack.extend(reversed([getattr(x, f.name)
                                   for f in dataclasses.fields(x)]))
        elif isinstance(x, (tuple, list)):
            out.append(("seq", len(x)))
            stack.extend(reversed(x))
        else:
            out.append(x)
    return out


def test_kernel_names_match():
    assert suite.KERNEL_NAMES == jsuite.KERNEL_NAMES
    assert len(suite.KERNEL_NAMES) == 20


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_stencil_ir_equal(name):
    j, t = PAIRS[name]
    assert _tokens(t.ir) == _tokens(j.ir)
    if name != "box3d4r":
        assert dataclasses.astuple(t.ir) == dataclasses.astuple(j.ir)
        assert repr(t.ir) == repr(j.ir)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_stencil_info_equal(name):
    j, t = PAIRS[name]
    assert dataclasses.astuple(t.info) == dataclasses.astuple(j.info)
    assert t.info.bytes_per_point_f32 == j.info.bytes_per_point_f32
    assert t.info.arithmetic_intensity_f32 == j.info.arithmetic_intensity_f32


# box3d4r's 729-tap sum nests too deep for the recursive linearize
@pytest.mark.parametrize("name", sorted(n for n in PAIRS if n != "box3d4r"))
def test_linearize_and_inline_equal(name):
    j, t = PAIRS[name]
    from repro.core import analysis as janalysis
    ja = janalysis.inline_locals(j.ir)
    ta = analysis.inline_locals(t.ir)
    assert [dataclasses.astuple(a) for a in ta] == \
        [dataclasses.astuple(a) for a in ja]
    for a_t, a_j in zip(ta, ja):
        terms_t, c_t = analysis.linearize(a_t.expr, allow_center_fields=True)
        terms_j, c_j = janalysis.linearize(a_j.expr, allow_center_fields=True)
        assert repr(sorted(terms_t.items())) == repr(sorted(terms_j.items()))
        assert repr(c_t) == repr(c_j)


def test_star_shape_and_order():
    k = suite.get_kernel("star3d4r")
    assert (k.info.shape, k.info.order, k.info.ndim) == ("star", 4, 3)
    assert k.info.halo == (4, 4, 4)
    assert k.info.n_taps == 25
    assert k.info.flops_per_point == 49


@pytest.mark.parametrize("name,flops", [
    ("star2d1r", 9), ("star2d2r", 17), ("star2d3r", 25), ("star2d4r", 33),
    ("star3d1r", 13), ("star3d2r", 25), ("star3d3r", 37), ("star3d4r", 49),
])
def test_paper_table4_star_flops(name, flops):
    assert suite.get_kernel(name).info.flops_per_point == flops


# ---- frontend errors, mirrored from tests/test_frontend.py -----------------
def test_parse_requires_type_hints():
    with pytest.raises(frontend.StencilSyntaxError):
        @st.kernel
        def bad(u, v):  # noqa: ANN001
            v.at(0).set(u.at(0))


def test_parse_rejects_noncenter_write():
    with pytest.raises(frontend.StencilSyntaxError):
        @st.kernel
        def bad(u: st.grid, v: st.grid):
            v.at(1, 0).set(u.at(0, 0))


def test_parse_rejects_dynamic_offsets():
    with pytest.raises(frontend.StencilSyntaxError):
        @st.kernel
        def bad(u: st.grid, v: st.grid, i: st.i32):
            v.at(0, 0).set(u.at(i, 0))


def test_parse_rejects_inconsistent_arity():
    with pytest.raises(frontend.StencilSyntaxError):
        @st.kernel
        def bad(u: st.grid, v: st.grid):
            v.at(0, 0).set(u.at(0, 0, 0))


def test_parse_rejects_unknown_call():
    with pytest.raises(frontend.StencilSyntaxError):
        @st.kernel
        def bad(u: st.grid, v: st.grid):
            v.at(0, 0).set(log(u.at(0, 0)))  # noqa: F821


def test_multi_statement_locals():
    @st.kernel
    def k(u: st.grid, v: st.grid, a: st.f32):
        t = u.at(-1, 0) + u.at(1, 0)
        v.at(0, 0).set(a * t + u.at(0, 0))

    assert k.info.halo == (1, 0)
    assert ("a", "f32") in k.ir.scalar_params
    assert isinstance(k.ir.body[0], ir.LocalDef)


def test_read_after_write_noncenter_rejected():
    with pytest.raises(ValueError, match="non-center read"):
        @st.kernel
        def bad(u: st.grid, v: st.grid):
            v.at(0, 0).set(u.at(0, 0))
            u.at(0, 0).set(v.at(1, 0))


def test_read_after_write_center_allowed():
    @st.kernel
    def ok(u: st.grid, v: st.grid):
        v.at(0, 0).set(u.at(1, 0))
        u.at(0, 0).set(v.at(0, 0) + 1.0)

    assert set(ok.ir.output_grids()) == {"v", "u"}


def test_linearize_rejects_product():
    @st.kernel
    def sq(u: st.grid, v: st.grid):
        v.at(0, 0).set(u.at(1, 0) * u.at(-1, 0))

    stmts = analysis.inline_locals(sq.ir)
    with pytest.raises(analysis.NotLinearError):
        analysis.linearize(stmts[0].expr)
