"""The port stands alone: no module of ``src/repro_torch/``, nor
``chip_smoke.py`` nor an ``examples/*_torch.py`` script, imports ``jax``,
``jaxlib`` or the JAX package ``repro`` (``import``, ``from ... import``, or
``importlib.import_module`` / ``__import__`` of a constant name), read from
each file's syntax tree. Only the tests import both packages."""
import ast
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted([*(ROOT / "src" / "repro_torch").rglob("*.py"),
                ROOT / "chip_smoke.py",
                *(ROOT / "examples").glob("*_torch.py")])
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported(tree: ast.AST):
    """Every module name the file imports, with its line."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module, node.lineno
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value, node.lineno


def test_the_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "examples/serve_lm_torch.py" in names
    assert "src/repro_torch/models/transformer.py" in names
    assert {"src/repro_torch/models/flash.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/train/train_step.py",
            "src/repro_torch/checkpoint/manager.py",
            "examples/train_lm_torch.py"} <= names
    assert len(names) > 50


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(name, line) for name, line in _imported(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_sees_each_form():
    src = ("import jax\nfrom repro.api import x\nimport jaxlib.xla\n"
           "import importlib\nimportlib.import_module('repro.core')\n"
           "__import__('jax.numpy')\nfrom repro_torch import api\n"
           "import repro_torch.models\nfrom . import sibling\n")
    got = [n for n, _ in _imported(ast.parse(src))
           if n.split(".")[0] in FORBIDDEN]
    assert sorted(got) == sorted(["jax", "repro.api", "jaxlib.xla",
                                  "repro.core", "jax.numpy"])
