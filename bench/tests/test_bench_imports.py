"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either.

Names are compared whole at the top level (the part before the first
dot): the port's package ``repro_torch`` begins with the JAX package's
name ``repro`` and is not it.
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_module_imports_no_jax_and_no_jax_package(path):
    banned = FORBIDDEN | ({"repro_torch"} if "reference" in path.parts else set())
    assert not top_level_imports(path) & banned


def test_the_check_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.core\nfrom repro_torchx import a\n")
    assert top_level_imports(src) == {"repro_torch", "repro_torchx"}
    src.write_text("import os, repro.core as rc\nfrom jax import numpy\n")
    assert top_level_imports(src) & FORBIDDEN == {"repro", "jax"}


def test_every_source_is_walked():
    assert BENCH / "run.py" in SOURCES
    assert any("reference" in p.parts for p in SOURCES)
