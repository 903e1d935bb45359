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


#: a cell over several cards, which the tests add to a small copy (the
#: benchmark has none yet): Euler's 16 members, a few steps a call, over
#: a dp mesh of ``world`` ranks, the configuration's IsompTorch with an
#: exit rule.  warm=False and no warm prefix, so that the reference
#: follows the rule from dW = 0; a tol at which the members' residuals
#: straddle it in a call's first step, so that a rank that decides from
#: its own members alone stops an iteration early there (N=16: 16
#: iterations in 4 steps against 17)
DP_CELL = "euler-n1024-c64.dp"
DP_MIX = {"batch": 16, "batched": True, "mesh": {"dp": 4, "tp": 1},
          "steps_out": 4, "outputs_per_call": 1, "check_intervals": 2,
          "exit_rule": {"tol": 3e-6, "maxit": 10, "minit": 1},
          "integrator": {"warm": False, "warm_precision": None},
          "initial_seed": 42}
#: the check's limits for it: the one-card Euler cells' gap, and room
#: for 4 iterations missed, summed over the intervals
DP_LIMITS = {"gap": {"W": 2e-3}, "iterations": 4}


def dp_copy(tmp_path, world, **mix_keys):
    """A small copy with DP_CELL on ``world`` ranks added as new files
    and entries, its mix DP_MIX updated by ``mix_keys``; returns the
    copy's root."""
    root = small_copy(tmp_path)
    here = root / "portbench"
    mix = json.loads(json.dumps(DP_MIX))
    mix.update(mix_keys)
    mix["mesh"]["dp"] = world
    (here / "traffic" / "dp.json").write_text(json.dumps(mix))
    (here / "limits" / f"{DP_CELL}.json").write_text(json.dumps(DP_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": DP_CELL, "config": "euler-n1024-c64", "traffic": "dp",
        "chips": world, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
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
