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
from portbench.tests.conftest import SMALL, small_cell

T0 = time.perf_counter()


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
    """A fresh process that runs a cell (CPU, small) holds no module whose
    top-level name is jax, jaxlib, flax or repro."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "from portbench.tests.conftest import small_cell\n"
        "harness.run(small_cell('acoustic-iso-512-shot'), 1, 0.2, True, 'cpu', time.perf_counter)\n"
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
    args = ["--workload", "star3d4r-512-fused", "--seed", "1", "--seconds", "1", "--trace", "0"]
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for root in (harness.ROOT, tmp_path):
        out = subprocess.run([sys.executable, "portbench/run.py", *args], cwd=root,
                             capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("name, traffic", [
    # row 1 of PERF.md's further cells: star3d4r step by step through st.map
    ("star3d4r-512-fused", {"driver": "map_steps", "steps_per_solve": 20,
                            "source_every": 0, "receivers_every": 0}),
    # row 2: acoustic shots in fused windows of 10, hooks at each boundary
    ("acoustic-iso-512-shot", {"driver": "fused_solves", "steps_per_solve": 60,
                               "fuse_steps": 10, "hooks_every": 10}),
])
def test_further_cells_are_data_only(name, traffic):
    """The next cells need only a traffic file: each driver runs either
    stencil, and the reference follows its schedule."""
    out = harness.run(small_cell(name, **traffic), 5, 0.2, False, "cpu", since)
    assert out["correct"] is True
    assert set(out["checks"]) == set(small_cell(name).limits)
