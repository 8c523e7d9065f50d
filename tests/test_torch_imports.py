"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``; and entry points
run on the card unless the caller asks for the CPU."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import acoustic, suite  # noqa: E402
from repro_torch.core import dsl as st  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


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


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.dsl")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")


@pytest.mark.parametrize("make", [
    lambda: st.grid(dtype=st.f32, shape=(4, 4), order=1),
    lambda: suite.make_grids("star2d1r", (4, 4)),
    lambda: acoustic.make_fields((4, 5, 6)),
    lambda: acoustic.run(shape=(4, 5, 6), iters=1),
], ids=["grid", "make_grids", "make_fields", "acoustic_run"])
def test_default_device_is_the_card(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert st.grid(shape=(4, 4), order=1, device="cpu").device.type == "cpu"
