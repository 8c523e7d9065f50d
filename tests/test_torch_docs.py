"""The documentation gate (``tools/check_docs.py``) on the port: the five
``repro_torch.core`` twins of the JAX package's public engine modules
(``dsl``, ``timeloop``, ``adjoint``, ``autotune``, ``halo``) have every
public name documented and their docstring examples run; the repo's
markdown links resolve.  The tool is run as it is, its ``PUBLIC_MODULES``
set to the port's modules for the test."""
import doctest
import importlib
import importlib.util
import pathlib
import re

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_MODULES = tuple(f"repro_torch.core.{m}"
                     for m in ("dsl", "timeloop", "adjoint", "autotune", "halo"))


@pytest.fixture
def check_docs(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "_check_docs", REPO / "tools" / "check_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "PUBLIC_MODULES", PORT_MODULES)
    return mod


def _examples(modname: str) -> int:
    """Docstring examples in a module, found without running them."""
    mod = importlib.import_module(modname)
    return sum(len(t.examples) for t in doctest.DocTestFinder().find(mod))


def test_port_modules_twin_the_jax_gate():
    """The tool's own list (read from its source) names the JAX twins of
    ``PORT_MODULES``, in order."""
    src = (REPO / "tools" / "check_docs.py").read_text()
    jax_modules = re.findall(r'"(repro\.core\.\w+)"', src)
    assert [m.replace("repro.", "repro_torch.") for m in jax_modules] == \
        list(PORT_MODULES)


def test_port_docstrings(check_docs, capsys):
    assert check_docs.check_docstrings() == 0, capsys.readouterr().out


def test_port_doctests(check_docs, capsys):
    assert check_docs.check_doctests() == 0, capsys.readouterr().out
    ran = int(re.search(r"OK \((\d+) examples\)", capsys.readouterr().out).group(1))
    want = sum(_examples(m.replace("repro_torch.", "repro.")) for m in PORT_MODULES)
    assert want == 16
    assert ran >= want


def test_markdown_links(check_docs, capsys):
    assert check_docs.check_links() == 0, capsys.readouterr().out
