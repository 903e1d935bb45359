"""Fixtures of the benchmark's tests: a copy of the benchmark at a small N
that the CPU can run, and the card where one is present."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: the configurations' N in the CPU copies
SMALL_N = 16


def small_copy(tmp_path, N=SMALL_N):
    """BENCHMARK.json and portbench/ copied under ``tmp_path``, every
    configuration cut to ``N``; returns the copy's root."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["N"] = N
        path.write_text(json.dumps(cfg))
    return root


@pytest.fixture
def small(tmp_path):
    return small_copy(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
