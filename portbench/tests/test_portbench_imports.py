"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: `cgs_tpu_torch` is the code under test, not
`cgs_tpu`), and the reference imports nothing of the port."""

import ast
import sys

import pytest
from _small import ROOT

from portbench.lib.harness import FORBIDDEN, forbidden_modules

BENCH = ROOT / "portbench"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert not names & {"cgs_tpu_torch", "cgs_tpu", "jax", "flax"}


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cgs_tpu_torch_lookalike", sys)
    assert "cgs_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "cgs_tpu.sub", sys)
    assert "cgs_tpu" in forbidden_modules()
