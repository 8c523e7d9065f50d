"""Every piece of the benchmark is found by the name ``BENCHMARK.json``
gives it, and the file keeps to the shape its readers rely on."""
import json
import re

import pytest

from portbench import harness
from portbench.stencils import leapfrog_pairs, pair_grids
from portbench.tests.conftest import SMALL

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.driver.Driver and cell.stencil.make_state and cell.reference.update
    assert set(cell.limits) >= set(pair_grids(leapfrog_pairs(cell.cfg["swap"])))
    assert cell.end_to_end and cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads_by_name(metric):
    assert callable(harness.load_module("metrics", metric).read)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    cfg = json.loads((harness.ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    assert conf["file"].startswith(BENCH["paths"][0] + "/")


def test_flops_per_point_are_the_expressions():
    """The yardstick's operations a point, and the grids it counts, are
    those of the program's DSL kernel as written, which each configuration's
    stencil file names."""
    for conf in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / conf["file"]).read_text())
        k = harness.load_module("stencils", cfg["stencil"]).kernel()
        assert cfg["flops_per_point"] == k.info.flops_per_point
        assert set(cfg["reads"]) == set(k.info.input_grids)
        assert set(cfg["writes"]) == set(k.info.output_grids)


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(WORKLOADS)
        assert all("workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
                   for w in m["workloads"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in WORKLOADS:
        mine = [m for m in METRICS if "workloads" not in m or w in m["workloads"]]
        assert "setup_s" in [m["name"] for m in mine]
        assert any(m in BENCH["per_layer"] for m in mine)
        assert any(m in BENCH["end_to_end"] and m["name"] != "setup_s" for m in mine)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_small_sizes_name_cells():
    """Every small size is a cell's, and keeps to the cell's driver."""
    assert SMALL and set(SMALL) <= set(WORKLOADS)
    for name, small in SMALL.items():
        assert set(small) == {"cfg", "traffic"} and "driver" not in small["traffic"], name


# stencil names may stand only in the stencil's own files: its state and
# binding, its reference, and the tests of its configurations
def stencil_words():
    stems = [p.stem for p in (harness.HERE / "stencils").glob("*.py") if p.stem != "__init__"]
    return stems, re.compile("(?<![A-Za-z0-9])(%s)" % "|".join(
        re.escape(s.split("_")[0]) for s in stems), re.IGNORECASE)


def test_no_stencil_is_named_outside_its_own_files():
    stems, word = stencil_words()
    own = {f"tests/test_portbench_{s}.py" for s in stems}
    found = []
    for path in sorted(harness.HERE.rglob("*.py")):
        rel = path.relative_to(harness.HERE).as_posix()
        if rel.startswith(("stencils/", "reference/")) or rel in own:
            continue
        found += [f"{rel}:{i}" for i, line in enumerate(path.read_text().splitlines(), 1)
                  if word.search(line)]
    assert stems and found == []
