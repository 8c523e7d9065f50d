"""The port's step accounting (``launch/op_analysis.py``) against the JAX
package's HLO walk (``launch/hlo_analysis.py``): the ring model, a loop's
trip count, K6 as one op, and the attribution of a meta mesh's ops to its
devices."""
import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as H  # noqa: E402
from repro_torch.kernels.conv1d import ops as conv_ops  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import op_analysis as oa  # noqa: E402
from repro_torch.models import sharded  # noqa: E402
from repro_torch import sharding  # noqa: E402

META = torch.device("meta")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _loop_step(x, w, trips=5):
    """5 × (an all-reduce of ``x``'s 256 bytes over 2 devices, then an
    8×8 f32 dot): the JAX test's ``while`` body."""
    for _ in oa.trips(range(trips)):
        oa.record("all-reduce", x.numel() * x.element_size(), 2, devices=8)
        x = x @ w
    return x


@pytest.mark.parametrize("sample", [False, True], ids=["full", "sampled"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_trip_counts(sample, device):
    """The counterpart of ``test_hlo_analysis_trip_counts``: 5 trips of one
    dot of 2·64·8 FLOPs and one all-reduce moving 2·256·(1/2) bytes, per
    device, whether the loop runs every trip or one charged five times."""
    x = torch.ones(8, 8, device=device)
    w = torch.ones(8, 8, device=device)
    with oa.Account(8, sample=sample) as a:
        _loop_step(x, w)
    st = a.per_device
    assert st.dot_flops == 5 * 2 * 64 * 8 / 8          # each dot on one of 8 devices
    assert st.coll_counts["all-reduce"] == 5
    assert st.coll_bytes["all-reduce"] == 5 * 256.0
    assert a.executed.dot_flops == 5 * 2 * 64 * 8
    assert a.executed.coll_bytes["all-reduce"] == 8 * 5 * 256.0
    assert a.n_ops == 5
    jx = H.Stats()
    jx.add_coll("all-reduce", H._coll_moved("all-reduce", 256, 2), 5)
    assert oa.summarize(st)["collective_bytes"] == H.summarize(jx)["collective_bytes"]


def test_call_replicated_op():
    """``call(r=)``: an op standing for r devices each doing all of it is
    charged r/n of its executed cost a device."""
    x = torch.ones(4, 16, device=META)
    w = torch.ones(16, 16, device=META)
    with oa.Account(8) as a:
        oa.call(torch.matmul, (x, w), r=8)
    assert a.per_device.dot_flops == a.executed.dot_flops == 2 * 4 * 16 * 16


@pytest.mark.parametrize("op", COLLECTIVES)
@pytest.mark.parametrize("g", range(1, 17))
def test_ring_model_matches_jax(op, g):
    for nbytes in (0, 1, 256, 12345, 1 << 30):
        assert oa._coll_moved(op, nbytes, g) == H._coll_moved(op, nbytes, g)


def test_stats_and_summary_keys_match_jax():
    import dataclasses
    assert [f.name for f in dataclasses.fields(oa.Stats)] == \
        [f.name for f in dataclasses.fields(H.Stats)]
    assert set(oa.summarize(oa.Stats())) == set(H.summarize(H.Stats()))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_k6_is_one_op(device):
    """K6 is one op of 2·cw FLOPs an output (vec: no contraction) and its
    x, w and output bytes; its plain version's ops on the CPU are not
    walked; on meta it computes nothing."""
    B, T, W, cw = 2, 9, 8, 4
    x = torch.randn(B, T, W).to(device)
    w = torch.randn(cw, W).to(device)
    with oa.Account(1) as a:
        y = conv_ops.causal_conv1d(x, w)
    assert y.shape == x.shape and y.device.type == device
    assert a.kernels == {"causal_conv1d": 1}
    assert a.n_ops == 1
    assert a.per_device.vec_flops == 2 * cw * B * T * W
    assert a.per_device.dot_flops == 0 and a.per_device.transcendentals == 0
    assert a.per_device.hbm_bytes == (2 * B * T * W + cw * W) * 4


def test_k6_gradient_counts_its_dx_launch():
    """``CausalConv1dFn``'s backward runs K6 once more (dx)."""
    x = torch.randn(2, 9, 8, requires_grad=True)
    w = torch.randn(4, 8, requires_grad=True)
    with oa.Account(1) as a:
        conv_ops.CausalConv1dFn.apply(x, w).sum().backward()
    assert a.kernels == {"causal_conv1d": 2}


def _mesh():
    return mesh_mod.make_mesh((1, 4), ("data", "model"), devices=[META])


def test_shard_attribution_replicated_and_stacked():
    """On a (1, 4) meta mesh a group's four model shards sit on the one
    meta device.  A product of a model-split value (one stack of the four
    shards' rows) is charged a quarter a device; a replicated one is one
    tensor that every shard computes on a mesh, so each device is charged
    all of it."""
    mesh = _mesh()
    (g,) = sharded.groups(mesh)
    x = g.replicate(torch.empty(6, 16, device=META))
    w_split = g.split(g.replicate(torch.empty(16, 32, device=META)), 1)
    w_rep = g.replicate(torch.empty(16, 32, device=META))
    full = 2 * 6 * 16 * 32
    with oa.Account(mesh.size) as a:
        y = x @ w_split
    assert y.sdim == 1
    assert a.executed.dot_flops == full
    assert a.per_device.dot_flops == full / 4
    with oa.Account(mesh.size) as a:
        y = x @ w_rep
    assert y.sdim is None
    assert a.executed.dot_flops == full
    assert a.per_device.dot_flops == full


def test_shard_attribution_reaches_the_backward_pass():
    """A stacked op's autograd nodes carry its place: its backward
    products are charged a quarter a device too; the sum of partials is
    an all-reduce over the four shards."""
    mesh = _mesh()
    (g,) = sharded.groups(mesh)
    x = g.replicate(torch.empty(6, 16, device=META))
    wt = torch.empty(16, 32, device=META, requires_grad=True)
    w_split = g.split(g.replicate(wt), 1)
    full = 2 * 6 * 16 * 32
    with oa.Account(mesh.size) as a, sharding.use_activation_mesh(mesh), \
            sharding.use_group(g):
        y = x @ w_split
        back = g.constrain(y @ g.split(g.replicate(torch.empty(32, 16, device=META)), 0),
                           (None, None))
        back.parts[0].sum().backward()
    # forward: two products of ``full`` FLOPs each; backward of the first:
    # dW only (x needs no gradient), of the second: dY only
    assert a.executed.dot_flops == 4 * full
    assert a.per_device.dot_flops == 4 * full / 4
    assert a.per_device.coll_counts == {"all-reduce": 1.0}
    assert a.per_device.coll_bytes["all-reduce"] == H._coll_moved("all-reduce", 6 * 16 * 4, 4)


def test_lead_charges_a_slab_row_a_device():
    """Under ``lead`` an op on a slab of k distinct blocks (a parameter's
    on a meta mesh) is charged 1/k a device."""
    slab = torch.empty(4, 8, 8, device=META)
    with oa.Account(16) as a, oa.lead():
        slab * 2.0
    assert a.executed.vec_flops == 4 * 64
    assert a.per_device.vec_flops == 64


def test_no_account_is_a_no_op():
    assert oa.active() is None
    oa.record("all-reduce", 256, 2)
    with oa.default_place(4), oa.lead(), oa.hidden(), oa.repeated(3):
        pass
    assert list(oa.trips(range(3))) == [0, 1, 2]
    assert oa.call(torch.add, (torch.ones(2), 1.0)).tolist() == [2.0, 2.0]
    with oa.Account(2):
        with pytest.raises(RuntimeError, match="already"):
            with oa.Account(2):
                pass
    assert oa.active() is None


def test_temp_bytes_peak_of_own_allocations():
    """Temporary bytes: the peak of the block's own storages live at once
    (a freed one no longer counts); tensors made before are not the
    step's."""
    arg = torch.empty(1024, device=META)
    with oa.Account(1) as a:
        t1 = arg + 1.0                       # 4 KiB
        t2 = t1 * 2.0                        # 8 KiB live
        del t1
        t3 = t2 * 3.0                        # 8 KiB live again
        del t2, t3
    assert a.temp_bytes == 8192
