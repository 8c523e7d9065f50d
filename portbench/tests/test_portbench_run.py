"""A whole run of each cell on the CPU at small sizes (the program's plain
versions in place of its kernels; the look for a card skipped): the shape
of the last line, the traced run's keys, and the checks on what the run
loads."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.stencils import leapfrog_pairs
from portbench.tests.conftest import SMALL, small_cell

T0 = time.perf_counter()
WORKLOADS = [w["name"] for w in
             json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def since():
    return time.perf_counter() - T0


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    cell = small_cell(name)
    out = harness.run(cell, 2 ** 31 + 99, 0.3, trace, "cpu", since)
    line = json.loads(json.dumps(out, allow_nan=False))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= wanted
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
        assert any(m.startswith("gpoints_per_s.") for m in line["metrics"])


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for m in list(sys.modules):
        if m.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A fresh process that runs every cell (CPU, small, traced) holds no
    module whose top-level name is jax, jaxlib, flax or repro."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "from portbench.tests.conftest import SMALL, small_cell\n"
        "for name in SMALL:\n"
        "    harness.run(small_cell(name, steps_per_solve=4), 1, 0.1, True, 'cpu',\n"
        "                time.perf_counter)\n"
        "print(harness.forbidden_modules())\n") % (str(harness.ROOT), str(harness.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_or_without_the_program_no_result(tmp_path):
    """Without a card (this CPU) the command exits nonzero and prints no
    result; so it does in a directory holding only the benchmark."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = ["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"]
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for root in (harness.ROOT, tmp_path):
        out = subprocess.run([sys.executable, "portbench/run.py", *args], cwd=root,
                             capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode != 0 and out.stdout.strip() == ""


def on_the_other_driver(traffic):
    """A cell's traffic moved to the other driver, with its hooks: a step
    loop's become a hook at every tenth step of fused windows of 10; fused
    solves become a step loop with the hooks' cadence."""
    steps = traffic["steps_per_solve"]
    if traffic["driver"] == "fused_solves":
        every = traffic.get("hooks_every") or 0
        return {"driver": "map_steps", "steps_per_solve": steps,
                "source_every": every, "receivers_every": every}
    hooks = traffic.get("source_every") or traffic.get("receivers_every")
    return {"driver": "fused_solves", "steps_per_solve": steps, "fuse_steps": 10,
            "hooks_every": 10 if hooks else 0}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_further_cells_are_data_only(name):
    """The next cells need only a traffic file: each driver runs each
    cell's stencil, and the reference follows its schedule.  The fused
    driver refuses several leapfrog pairs (the program's ``st.timeloop``
    takes one)."""
    cell = small_cell(name)
    moved = small_cell(name, **on_the_other_driver(cell.traffic))
    if moved.traffic["driver"] == "fused_solves" and len(leapfrog_pairs(cell.cfg["swap"])) > 1:
        with pytest.raises(ValueError, match="one leapfrog pair"):
            harness.run(moved, 5, 0.2, False, "cpu", since)
        return
    out = harness.run(moved, 5, 0.2, False, "cpu", since)
    assert out["correct"] is True
    assert set(out["checks"]) == set(cell.limits)
