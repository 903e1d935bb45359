"""What a run may load and read: no module of the JAX side, compared by
whole top-level names; the reference nothing of the program; nothing of
the benchmark reads the JAX package's benchmarks, bench.py or
chip_smoke.py."""

import ast
import json
import subprocess
import sys

import pytest

from conftest import REPO, small_copy
from portbench import harness

BENCH = REPO / "portbench"


@pytest.mark.parametrize("loaded,found", [
    (["quflow_tpu_torch", "quflow_tpu_torch.ops.laplacian", "torch"], []),
    (["quflow_tpu", "quflow_tpu.ops"], ["quflow_tpu", "quflow_tpu.ops"]),
    (["jax._src.core", "jaxlib"], ["jax._src.core", "jaxlib"]),
    (["flax", "jaxtyping", "jax_extra"], ["flax"]),
])
def test_forbidden_names_are_compared_whole(loaded, found):
    assert harness.forbidden_modules(dict.fromkeys(loaded)) == found


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    """Plain libraries and the reference's own modules (a scheme file
    imports the shared loop by its whole name, being loaded by path)."""
    tree = ast.parse(path.read_text())
    own = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
           and n.level == 0 and n.module.startswith("portbench.reference.")}
    assert own <= {"portbench.reference.scheme"}
    names = _imports(path) - ({"portbench"} if own else set())
    assert names <= {"__future__", "math", "numpy", "scipy", "torch"}


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_benchmark_reads_no_jax_side_file(path):
    """No string of the code (docstrings aside) names such a file, and no
    import names the JAX side."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
               and isinstance(n.value, str) and id(n) not in docs]
    for name in ("chip_smoke", "bench.py", "benchmarks", "quflow_tpu."):
        assert not [s for s in strings if name in s], f"{path} names {name}"
    assert not _imports(path) & {"jax", "jaxlib", "flax", "quflow_tpu"}


def test_a_run_loads_no_jax_module(tmp_path):
    """A CPU run of a cell in a fresh process, then the check that the
    benchmark makes once its window has closed."""
    root = small_copy(tmp_path)
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(root)!r}); sys.path.insert(1, {str(REPO)!r})\n"
        "from portbench import harness\n"
        f"cell = harness.Cell(harness.load_benchmark({str(root)!r}),"
        " 'euler-n1024-c64.single', root=harness.Path("
        f"{str(root)!r}), here=harness.Path({str(root)!r}) / 'portbench')\n"
        "run, program = harness.measure(cell, 1, 0.1, 0, device='cpu')\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
