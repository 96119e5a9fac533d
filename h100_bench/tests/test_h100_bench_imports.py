"""What the benchmark imports: nothing under ``h100_bench/`` imports JAX or
the JAX package, and the plain reference imports nothing of the measured
program. Module names are compared by their top-level name whole
(``mmidv1_tpu_torch`` begins with ``mmidv1_tpu``)."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_JAX = {"jax", "jaxlib", "flax", "mmidv1_tpu"}


def _sources(sub=""):
    base = os.path.join(HERE, sub)
    for dirpath, _dirs, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def top_level_imports(path):
    """The top-level names of every absolute import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & NO_JAX


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_is_plain(path):
    names = top_level_imports(path)
    assert names <= {"__future__", "math", "os", "typing", "numpy", "torch"}, names


def test_names_compared_whole():
    """The check tells the port's name from the JAX package's."""
    mods = ["mmidv1_tpu_torch.ops", "mmidv1_tpu_torch", "numpy"]
    assert not {m.split(".")[0] for m in mods} & NO_JAX
    assert {m.split(".")[0] for m in ["mmidv1_tpu.ops"]} & NO_JAX
