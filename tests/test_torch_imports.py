"""The port stands alone: no module of ``src/repro_torch``, no example
under ``examples/torch_port/`` and not ``chip_smoke.py`` imports JAX or the
JAX package ``repro``; and entry points run on the card unless the caller
asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import acoustic, cost_model, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples" / "torch_port").glob("*.py"))
FILES = (sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
         + EXAMPLES)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_files_found():
    assert len(FILES) >= 15
    assert (REPO / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    bad = [(ln, m) for ln, m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path}: imports {bad}"


# the LM serving slice: configs, models, K6, K7, serving, the CLI
SERVING_MODULES = (
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.recurrentgemma_9b", "repro_torch.models.layers",
    "repro_torch.models.griffin", "repro_torch.models.api",
    "repro_torch.kernels._build", "repro_torch.kernels.conv1d.conv1d",
    "repro_torch.kernels.conv1d.ops", "repro_torch.kernels.conv1d.ref",
    "repro_torch.kernels.decode_attn.decode_attn",
    "repro_torch.kernels.decode_attn.ops", "repro_torch.kernels.decode_attn.ref",
    "repro_torch.serving.serve_loop", "repro_torch.launch.serve",
    "repro_torch.interop")


@pytest.mark.parametrize("mod", SERVING_MODULES)
def test_serving_modules_are_checked(mod):
    path = REPO / "src" / (mod.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    assert path in FILES


# the training slice: shapes, optimizer, data, the step, the CLI
TRAINING_MODULES = (
    "repro_torch.configs.shapes", "repro_torch.train",
    "repro_torch.train.optimizer", "repro_torch.train.data",
    "repro_torch.train.train_loop", "repro_torch.launch.train")


@pytest.mark.parametrize("mod", TRAINING_MODULES)
def test_training_modules_are_checked(mod):
    path = REPO / "src" / (mod.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    assert path in FILES


# the cost model and the autotuner
AUTOTUNE_MODULES = ("repro_torch.core.cost_model", "repro_torch.core.autotune")


@pytest.mark.parametrize("mod", AUTOTUNE_MODULES)
def test_autotune_modules_are_checked(mod):
    assert REPO / "src" / (mod.replace(".", "/") + ".py") in FILES


def test_autotune_modules_load_neither_jax_nor_repro():
    """Importing the cost model and the autotuner in a fresh interpreter
    leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in AUTOTUNE_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(bad)\n"
              "assert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# resilience and stencil serving
RESILIENCE_MODULES = ("repro_torch.train.checkpoint", "repro_torch.train.fault_tolerance",
                      "repro_torch.serving.stencil_serve")


@pytest.mark.parametrize("mod", RESILIENCE_MODULES)
def test_resilience_modules_are_checked(mod):
    assert REPO / "src" / (mod.replace(".", "/") + ".py") in FILES


def test_resilience_modules_load_neither_jax_nor_repro():
    """Importing the checkpoint, restart and stencil-serving modules in a
    fresh interpreter leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in RESILIENCE_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(bad)\n"
              "assert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_training_modules_load_neither_jax_nor_repro():
    """Importing every module of the training slice in a fresh interpreter
    leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in TRAINING_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(bad)\n"
              "assert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_serving_modules_load_neither_jax_nor_repro():
    """Importing every module of the serving slice in a fresh interpreter
    leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SERVING_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(bad)\n"
              "assert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# the dry run's accounting
DRYRUN_MODULES = ("repro_torch.launch.op_analysis", "repro_torch.launch.dryrun")


@pytest.mark.parametrize("mod", DRYRUN_MODULES)
def test_dryrun_modules_are_checked(mod):
    assert REPO / "src" / (mod.replace(".", "/") + ".py") in FILES


def test_dryrun_modules_load_neither_jax_nor_repro():
    """Importing the dry run and its accounting in a fresh interpreter
    leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in DRYRUN_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(bad)\n"
              "assert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.dsl")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")


@pytest.mark.parametrize("make", [
    lambda: st.grid(dtype=st.f32, shape=(4, 4), order=1),
    lambda: suite.make_grids("star2d1r", (4, 4)),
    lambda: acoustic.make_fields((4, 5, 6)),
    lambda: acoustic.run(shape=(4, 5, 6), iters=1),
    lambda: api.init_params(configs.tiny(configs.get("recurrentgemma-9b"))),
    lambda: api.init_cache(configs.tiny(configs.get("recurrentgemma-9b")), 1, 4),
    lambda: serve.main(["--requests", "1"]),
    lambda: train_loop.init_state(configs.tiny(configs.get("recurrentgemma-9b"))),
    lambda: train_cli.main(["--steps", "1"]),
    lambda: cost_model.CostModel(calibrate=False),
    lambda: cost_model.default_model(),
], ids=["grid", "make_grids", "make_fields", "acoustic_run", "init_params",
        "init_cache", "serve_cli", "init_state", "train_cli", "cost_model",
        "default_model"])
def test_default_device_is_the_card(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert st.grid(shape=(4, 4), order=1, device="cpu").device.type == "cpu"


# the distributed stencil layer
DISTRIBUTED_MODULES = ("repro_torch.core.halo", "repro_torch.core.distributed",
                       "repro_torch.launch.mesh")


@pytest.mark.parametrize("mod", DISTRIBUTED_MODULES)
def test_distributed_modules_are_checked(mod):
    assert REPO / "src" / (mod.replace(".", "/") + ".py") in FILES


def test_distributed_modules_load_neither_jax_nor_repro():
    """Importing the halo geometry (the port's own copy of the JAX
    package's), the distributed runtime and the meshes in a fresh
    interpreter leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in DISTRIBUTED_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(bad)\n"
              "assert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# the LM side of the distributed layer: the sharding rules and placement,
# the sharded execution of the families
LM_DISTRIBUTED_MODULES = ("repro_torch.sharding", "repro_torch.models.sharded")


@pytest.mark.parametrize("mod", LM_DISTRIBUTED_MODULES)
def test_lm_distributed_modules_are_checked(mod):
    assert REPO / "src" / (mod.replace(".", "/") + ".py") in FILES


def test_lm_distributed_modules_load_neither_jax_nor_repro():
    """Importing the sharding rules and the sharded execution in a fresh
    interpreter leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in LM_DISTRIBUTED_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "print(bad)\n"
              "assert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_production_mesh_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--preset", "full", "--steps", "1"])


# the examples of the port
def test_examples_are_checked():
    assert [p.stem for p in EXAMPLES] == ["acoustic_iso_3d", "fwi", "quickstart",
                                          "serve_lm", "train_lm"]
    assert all(p in FILES for p in EXAMPLES)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_examples_load_neither_jax_nor_repro(path):
    """Loading an example in a fresh interpreter (its module body: the
    kernels it parses, the port modules it imports) leaves ``jax`` and
    ``repro`` out of ``sys.modules``."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "assert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
