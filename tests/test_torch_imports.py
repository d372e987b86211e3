"""Static guard: the port stands alone. No module of ``src/repro_torch/``,
no example of ``examples/torch/`` and not ``chip_smoke.py`` imports JAX
or the JAX package (``repro``); ``repro_torch`` itself is fine. Parsed
with ``ast``, nothing imported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
         + sorted((ROOT / "examples" / "torch").glob("*.py"))
         + [ROOT / "chip_smoke.py"])


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    """(line, module name) of every import, including the module named by
    a literal (or the literal head of an f-string) given to
    ``import_module``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module"):
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield node.lineno, arg.value


def test_the_guard_sees_the_port():
    assert len(FILES) > 20
    assert any(p.name == "model.py" for p in FILES)
    assert sum(p.parent.name == "torch" for p in FILES) == 4


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    bad = [f"{path.relative_to(ROOT)}:{line}: {name}"
           for line, name in _imports(path) if _forbidden(name)]
    assert not bad, "the port imports JAX or the reference:\n" + "\n".join(bad)


@pytest.mark.parametrize("src,bad", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jax import numpy", True), ("import repro", True),
    ("from repro.models import model", True), ("import repro.core", True),
    ("importlib.import_module('repro.configs.x')", True),
    ("importlib.import_module(f'repro.configs.{m}')", True),
    ("import repro_torch", False), ("from repro_torch.models import model",
                                    False),
    ("importlib.import_module(f'repro_torch.configs.{m}')", False),
    ("from . import ops", False), ("import numpy", False)])
def test_guard_catches_what_it_should(tmp_path, src, bad):
    f = tmp_path / "m.py"
    f.write_text(src + "\n")
    assert any(_forbidden(n) for _, n in _imports(f)) is bad
