"""``st.map``'s run-ahead on the card, on the CPU: the grids report a CUDA
device while their tensors stay on the CPU (the kernels' plain versions
run), and the CUDA events and syncs are stand-ins that log each call.  An
event reads as still running until the host waits for it, as a kernel
longer than the host's work between applications would.

On one CUDA device each application records an event and waits for the
one before it, never for the device; ``st.launch`` drains the last one
before it returns, and a launch that ran no ``st.map`` waits for nothing.
The distributed backend and the cost model's probe keep a sync after
every application."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import acoustic, cost_model, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402

CUDA = torch.device("cuda", 0)


class _Card:
    """The log of the stand-ins' calls: ``("record", e)``, ``("wait", e)``
    for an event ``e`` (numbered as made) and ``("sync", device)``."""

    def __init__(self, finished: bool):
        self.log, self.events, self.finished = [], [], finished
        card = self

        class Event:
            def __init__(self):
                self.n = len(card.events)
                card.events.append(self)
                self.done = True

            def record(self, stream=None):
                assert stream == "stream"
                card.log.append(("record", self.n))
                self.done = card.finished

            def query(self):
                return self.done

            def synchronize(self):
                card.log.append(("wait", self.n))
                self.done = True
        self.Event = Event

    def sync(self, device=None):
        self.log.append(("sync", device))
        for e in self.events:
            e.done = True

    def calls(self, kind):
        return [x for k, x in self.log if k == kind]


@pytest.fixture
def card(monkeypatch):
    """Grids on 'the card' whose kernels take longer than the host's work."""
    return _stand_in(monkeypatch, finished=False)


def _stand_in(monkeypatch, finished, on_card=True):
    c = _Card(finished)
    if on_card:
        monkeypatch.setattr(st.grid, "device", property(lambda self: CUDA))
    monkeypatch.setattr(torch.cuda, "Event", c.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", c.sync)
    monkeypatch.setattr(st, "_AHEAD", st._Ahead())
    return c


def _fields():
    return acoustic.make_fields((12, 12, 12), pml_width=3, device="cpu")


@st.target
def _shot(p0, p1, vp2, damp, dt, steps):
    for t in range(steps):
        acoustic.inject_source(p1, t)
        st.map(e=p0.shape)(acoustic.acoustic_iso_kernel)(p0, p1, vp2, damp, dt)
        p0.data, p1.data = p1.data, p0.data


@pytest.mark.parametrize("backend", ["torch", "gmem"])
def test_each_application_waits_for_the_one_before(card, backend):
    """Four applications on one device: each records an event and waits
    for the previous application's; the launch's drain waits for the
    last; no device-wide sync; two events serve every application."""
    be = st.torch() if backend == "torch" else st.hopper(template=backend)
    st.launch(backend=be)(_shot)(*_fields(), 4)
    events = card.calls("record")
    assert len(events) == 4 and len(card.events) == 2
    assert events == [0, 1, 0, 1]
    assert card.calls("wait") == events        # steps 1-3 wait for 0-2, the drain for 3
    assert card.log[:3] == [("record", 0), ("record", 1), ("wait", 0)]
    assert card.log[-1] == ("wait", 1)
    assert not card.calls("sync")


def test_launch_returns_after_its_last_application(card):
    """The drain is the launch's last wait, inside its ``kernel`` phase;
    the next launch starts with nothing left running."""
    f = _fields()
    run = st.launch(backend=st.hopper())(_shot)
    prof = run(*f, 2).profile
    assert card.log == [("record", 0), ("record", 1), ("wait", 0), ("wait", 1)]
    assert not st._AHEAD.pending and prof["kernel"] > 0
    card.log.clear()
    run(*f, 1)
    assert card.log == [("record", 0), ("wait", 0)]


def test_a_launch_with_no_map_waits_for_nothing(card):
    """``st.timeloop`` (the fused engine, on the grids' tensors) and
    ``inject_source`` leave no application running: the launch neither
    drains nor syncs."""
    p0, p1, vp2, damp, dt = _fields()

    @st.target
    def solve(*a):
        acoustic.inject_source(p1, 0)
        return st.timeloop(3, swap=("p0", "p1"))(acoustic.acoustic_iso_kernel)(*a)

    res = st.launch(backend=st.hopper())(solve)(p0, p1, vp2, damp, dt)
    assert card.log == [] and not card.events and res.counts == {}


def test_a_map_outside_a_launch_returns_finished(card):
    """With no launch open to drain it, an application waits for itself."""
    p0, p1, vp2, damp, dt = _fields()
    for _ in range(2):
        st.map(e=p0.shape)(acoustic.acoustic_iso_kernel)(p0, p1, vp2, damp, dt)
    assert card.log == [("record", 0), ("wait", 0), ("record", 0), ("wait", 0)]
    assert not st._AHEAD.pending


def test_distributed_syncs_after_every_application(card):
    """The distributed backend keeps its sync after each application and
    records no event."""
    k = suite.get_kernel("star2d1r")
    m = pmesh.make_mesh((2,), ("data",), devices=[torch.device("cpu")] * 2)
    g = suite.make_grids("star2d1r", (16, 12), seed=1, device="cpu")
    be = st.distributed(grid_axes=("data", None), inner=st.hopper())

    def loop(u, v):
        for _ in range(3):
            st.map(e=u.shape)(k)(u, v)

    st.launch(backend=be, mesh=m)(loop)(g["u"], g["v"])
    assert card.log == [("sync", CUDA)] * 3 and not card.events


def test_cost_model_probe_syncs_after_every_application(card):
    """``time_map`` times whole applications: its own sync after each, so
    the profile's ``kernel`` over ``apps`` is one application's time."""
    p0, p1, vp2, damp, dt = _fields()
    grids = {"p0": p0, "p1": p1, "vp2": vp2, "damp": damp}
    times = cost_model.time_map(acoustic.acoustic_iso_kernel, grids, {"dt": dt},
                                st.hopper(), iters=2, apps=3)
    assert len(times) == 2 and min(times) > 0
    assert card.calls("sync") == [CUDA] * 6
    # every application has finished before the next: the waits are the
    # drains of the warm-up launch and of the two timed ones
    assert len(card.calls("wait")) == 3


@pytest.mark.parametrize("finished,overlapped", [(False, 4), (True, 0)],
                         ids=["kernel-longer", "host-longer"])
def test_counts_applications_that_ran_ahead(monkeypatch, finished, overlapped):
    """``rt.map.apps`` counts a launch's applications on the card,
    ``rt.map.overlapped`` those launched while the one before still ran:
    all but the first where the kernel outlasts the host's work, none
    where each has finished by the next launch."""
    _stand_in(monkeypatch, finished)
    res = st.launch(backend=st.hopper())(_shot)(*_fields(), 5)
    assert res.counts["rt.map.apps"] == 5
    assert res.counts.get("rt.map.overlapped", 0) == overlapped


@pytest.mark.parametrize("backend", ["torch", "gmem"])
def test_cpu_grids_wait_for_nothing(monkeypatch, backend):
    """On CPU grids an application runs to its end: no event, no sync, no
    count."""
    c = _stand_in(monkeypatch, finished=False, on_card=False)
    be = st.torch() if backend == "torch" else st.hopper(template=backend)
    res = st.launch(backend=be)(_shot)(*_fields(), 3)
    assert c.log == [] and not c.events and res.counts == {}
