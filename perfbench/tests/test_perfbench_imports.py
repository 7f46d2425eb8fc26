"""What the benchmark may import: nothing of the JAX side on the chip
path (compared by whole top-level names: trlx_tpu_torch starts with
trlx_tpu), and nothing of the program in the plain reference, the
architectures' modules included."""

import ast
import os

import pytest

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "trlx_tpu"}


def modules(folder):
    for root, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules(harness.HERE)))
def test_no_jax_side_on_the_chip_path(path):
    assert not set(top_level_imports(path)) & FORBIDDEN, path


@pytest.mark.parametrize("path", sorted(
    [*modules(os.path.join(harness.HERE, "reference")),
     *modules(os.path.join(harness.HERE, "arch"))]))
def test_reference_imports_nothing_of_the_program(path):
    assert "trlx_tpu_torch" not in set(top_level_imports(path)), path


def test_the_run_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    for name in ("jax", "jaxlib", "flax", "trlx_tpu", "trlx_tpu.ops"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "trlx_tpu_torch.fake",
                        types.ModuleType("trlx_tpu_torch.fake"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla",
                        types.ModuleType("jaxlib.xla"))
    monkeypatch.setitem(sys.modules, "trlx_tpu.ops",
                        types.ModuleType("trlx_tpu.ops"))
    assert harness.forbidden_modules() == ["jaxlib", "trlx_tpu"]
