"""quflow_tpu_torch's top level against the reference's public names:
every name of tests/test_api_parity.py's list resolves on the port, the
module aliases carry their counterparts' names, and no module of the
port, nor chip_smoke.py, imports JAX or quflow_tpu."""

import importlib
import re
from pathlib import Path

import pytest

import quflow_tpu as qf
import quflow_tpu_torch as qt

from test_api_parity import REFERENCE_PUBLIC_NAMES

ROOT = Path(__file__).resolve().parent.parent

#: name -> the ROADMAP.md item that ports it; empty since every item landed
EXPECTED_MISSING = {}


@pytest.mark.parametrize("name", REFERENCE_PUBLIC_NAMES)
def test_reference_public_name(name):
    assert hasattr(qf, name)
    assert name not in EXPECTED_MISSING
    assert hasattr(qt, name), f"{name} is missing from quflow_tpu_torch"


def test_expected_missing_are_reference_names():
    assert set(EXPECTED_MISSING) <= set(REFERENCE_PUBLIC_NAMES)


@pytest.mark.parametrize("module", ["graphics", "cluster"])
def test_a10_modules(module):
    """graphics and cluster carry every name of quflow_tpu's modules."""
    ours = importlib.import_module(f"quflow_tpu_torch.{module}")
    theirs = importlib.import_module(f"quflow_tpu.{module}")
    for name in theirs.__all__:
        assert hasattr(ours, name), f"{module}.{name}"
    assert getattr(qt, module) is ours


#: an import of JAX or of quflow_tpu (not quflow_tpu_torch), as a
#: statement or through importlib/__import__
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib)\b|from\s+(jax|jaxlib)\b"
    r"|import\s+quflow_tpu\b(?!_)|from\s+quflow_tpu\b(?!_))"
    r"|import_module\(\s*['\"](jax|quflow_tpu)\b(?!_)"
    r"|__import__\(\s*['\"](jax|quflow_tpu)\b(?!_)", re.M)


def test_forbidden_imports_pattern():
    for line in ("import jax", "from jax import lax", "import jax.numpy as jnp",
                 "    from quflow_tpu.ops import sht", "import quflow_tpu as qf",
                 "importlib.import_module('quflow_tpu.native')"):
        assert FORBIDDEN.search(line), line
    for line in ("import quflow_tpu_torch as qt", "from quflow_tpu_torch import x",
                 "from .ops import jaxlike", "# import jax in a comment? no",
                 "from .. import config"):
        assert not FORBIDDEN.search(line), line


def test_port_never_imports_jax_or_quflow_tpu():
    """Every module of quflow_tpu_torch/, chip_smoke.py and the example
    twins (examples/torch_*.py): no import of JAX or of quflow_tpu, not
    even a module of it that does not import JAX."""
    files = sorted((ROOT / "quflow_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    twins = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(twins) == 3
    files += twins
    assert len(files) > 40
    offenders = [f"{path.relative_to(ROOT)}: {m.group(0).strip()}"
                 for path in files
                 for m in FORBIDDEN.finditer(path.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("module", ["simulation", "experimental",
                                    "analysis", "dynamics"])
def test_alias_modules(module):
    ours = importlib.import_module(f"quflow_tpu_torch.{module}")
    theirs = importlib.import_module(f"quflow_tpu.{module}")
    missing = {"IsompTPU", "MagmpTPU"}
    for name in set(theirs.__all__) - missing:
        assert hasattr(ours, name), f"{module}.{name}"
    if module == "experimental":
        assert ours.IsompCUDA is qt.IsompTorch
        assert ours.DiagTriDiagOp is qt.parallel.stepper.build_poisson_fn


@pytest.mark.parametrize("module", ["parallel.stepper", "ops.diagpack",
                                    "parallel.shard_pack"])
def test_module_all_parity(module):
    """The ``__all__`` of the stepper, the packs and the wrapped relayout:
    every name of quflow_tpu's is in the port's (IsompTPU and MagmpTPU as
    IsompTorch and MagmpTorch) and resolves."""
    ours = importlib.import_module(f"quflow_tpu_torch.{module}")
    theirs = importlib.import_module(f"quflow_tpu.{module}")
    renamed = {"IsompTPU": "IsompTorch", "MagmpTPU": "MagmpTorch"}
    for name in theirs.__all__:
        name = renamed.get(name, name)
        assert name in ours.__all__, f"{module}.{name}"
        assert hasattr(ours, name), f"{module}.{name}"


def test_backend_module_paths():
    from quflow_tpu_torch.laplacian import cpu, direct, gpu, sparse, tridiagonal

    for mod in (cpu, direct, sparse, gpu, tridiagonal):
        assert hasattr(mod, "solve_poisson")
    assert callable(direct.compute_direct_laplacian)
