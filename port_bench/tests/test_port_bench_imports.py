"""No module of the benchmark or of the port imports JAX or the JAX package,
compared by whole top-level name, and the reference imports nothing of the
program under test."""

from __future__ import annotations

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "asf_tpu"}


def _modules(package: str):
    for base, _dirs, files in os.walk(os.path.join(ROOT, package)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imports(path: str) -> set:
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("package", ["port_bench", "asf_tpu_torch"])
def test_no_jax(package):
    bad = {p: _imports(p) & FORBIDDEN for p in _modules(package)}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    for p in _modules(os.path.join("port_bench", "reference")):
        assert not _imports(p) & (FORBIDDEN | {"asf_tpu_torch"}), p


def test_whole_names_are_compared():
    from port_bench.run import FORBIDDEN as RUN_FORBIDDEN

    assert "asf_tpu_torch".split(".", 1)[0] not in RUN_FORBIDDEN
    assert "asf_tpu" in RUN_FORBIDDEN
