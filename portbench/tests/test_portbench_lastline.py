"""The shape of a run's result, and the runs that print none."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import DP_CELL, REPO, dp_copy
from portbench import harness
from portbench.check import check_run


def test_result_line_has_the_contracts_keys_checks_last(small):
    cell = harness.Cell(harness.load_benchmark(small), "mhd-n1024-c64.single",
                        root=small, here=small / "portbench")
    run, program = harness.measure(cell, 2 ** 31 + 7, 0.2, 0, device="cpu")
    metrics = harness.read_metrics(cell, run, cell.end_to_end)
    harness.release(program)
    correct, attempted, failed = check_run(run)
    run.device = {"platform": "gpu", "kind": "x", "count": 1,
                  "memory_peak_bytes": 1}
    line = json.loads(json.dumps(harness.result_line(
        run, correct, attempted, failed, metrics)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == run.recorder.count > 0
    assert set(line["metrics"]) == {"state_steps_per_s",
                                    "output_interval_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["checks"]) == {"gap_P_start", "gap_P_window",
                                   "gap_Theta_start", "gap_Theta_window"}
    for c in line["checks"].values():
        assert c["value"] < c["limit"]
    assert run.recorder.first.shape == (2, 16, 16)
    assert run.recorder.first.dtype == np.complex64


def _run_py(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("chips", [1, 4])
def test_no_card_no_result(tmp_path, chips):
    """No card: no result, whether one process looks or each rank of a
    cell over four cards."""
    name, cwd = "euler-n1024-c64.single", REPO
    if chips > 1:
        name, cwd = DP_CELL, dp_copy(tmp_path, chips)
    out = _run_py(cwd, "--workload", name, "--seed", "3000000000",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert f"needs {chips} CUDA device" in out.stderr


def test_unknown_workload_no_result():
    out = _run_py(REPO, "--workload", "nothing", "--seed", "1",
                  "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    """A directory with BENCHMARK.json and portbench/ only."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _run_py(tmp_path, "--workload", "euler-n1024-c64.single",
                  "--seed", "1", "--seconds", "1", "--trace", "1")
    assert out.returncode != 0 and out.stdout == ""
