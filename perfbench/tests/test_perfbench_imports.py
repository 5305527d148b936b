"""What the benchmark's files import: no JAX and no JAX package anywhere,
and nothing of the program in the reference, the generators and the
counts."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from perfbench import core

FILES = sorted(p for p in core.BENCH.rglob("*.py") if "tests" not in p.parts)
#: the yardstick: these import neither the program nor JAX
YARDSTICK = ("reference", "data", "work")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_top_level_names_are_compared_whole():
    assert core.forbidden_modules(["keystone_tpu_torch", "keystone_tpu_torch.ops",
                                   "torch", "jax_like"]) == []
    assert core.forbidden_modules(["keystone_tpu.ops", "jaxlib.xla",
                                   "flax", "numpy"]) == ["flax", "jaxlib",
                                                         "keystone_tpu"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(core.BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(core.FORBIDDEN), tops
    assert "bench" not in tops


@pytest.mark.parametrize("path", [p for p in FILES
                                  if p.parent.name in YARDSTICK],
                         ids=lambda p: str(p.relative_to(core.BENCH)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "contextlib", "typing", "numpy", "torch",
                    "perfbench"}, tops
    assert not any(name.startswith("perfbench.adapters")
                   or name == "perfbench.program" for name in _imports(path))


def test_importing_the_harness_loads_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.core, perfbench.trace, perfbench.program; "
            "from perfbench import core; "
            "[core.load_module('drivers', d) for d in "
            "('fit_resident', 'fit_streamed', 'apply')]; "
            "[core.load_module('adapters', a) for a in ('rpc_cifar', 'timit')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'keystone_tpu_torch', 'keystone_tpu', 'jax'}))"
            % str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
