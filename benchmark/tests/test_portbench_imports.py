"""What the benchmark may load: nothing of JAX or the JAX package, by the
whole top-level module name (``sparsernns_tpu_torch`` begins with
``sparsernns_tpu`` and is allowed), and the reference nothing of the
program."""

import ast
import os
import sys

import pytest

from benchmark.harness import core, spec

BENCH_DIR = spec.HERE


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = set(_imports(path)) & {"jax", "jaxlib", "flax", "sparsernns_tpu"}
    assert not found


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "sparsernns_tpu_torch" not in set(_imports(path))


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sparsernns_tpu_torch_probe", sys)
    assert core.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "sparsernns_tpu.train", sys)
    assert "sparsernns_tpu" in core.forbidden_modules()
