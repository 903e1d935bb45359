"""The example twins of quflow_tpu_torch (examples/torch_*.py) at small N
on the CPU (``--device cpu``): each runs to its report and holds the
conservation its JAX twin reports; the basic twin logs in memory when
h5py does not import; the ensemble twin splits its members over a dp mesh
of two gloo processes, as torchrun starts it."""

import importlib.util
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("h5py", [True, False])
def test_basic_twin(tmp_path, capsys, monkeypatch, h5py):
    if h5py:
        pytest.importorskip("h5py")
    else:
        monkeypatch.setitem(sys.modules, "h5py", None)  # import fails
    out = _example("torch_basic_simulation").main([
        "--N", "16", "--simtime", "0.5", "--steps-out", "5", "--device",
        "cpu", "--outfile", str(tmp_path / "basic.hdf5")])
    text = capsys.readouterr().out
    assert out["steps"] == 16 and len(out["energy"]) == 5
    assert out["casimir_drift"] <= 1e-9
    assert abs(out["enstrophy"][-1] - out["enstrophy"][0]) <= 1e-10
    assert (tmp_path / "basic.hdf5").exists() is h5py
    assert ("h5py does not import" in text) is not h5py


def test_ensemble_twin(capsys):
    out = _example("torch_ensemble_simulation").main([
        "--N", "16", "--steps", "5", "--device", "cpu"])
    assert out["final"].shape == (4, 16, 16)
    assert np.isfinite(out["final"]).all() and out["casimir_drift"] <= 1e-9
    assert "dp=1, captured: False" in capsys.readouterr().out


def test_ensemble_twin_on_a_dp_mesh_of_two_processes():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = str(ROOT / "examples" / "torch_ensemble_simulation.py")
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, script, "--N", "12", "--steps", "3",
             "--device", "cpu"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "dp=2" in outs[0][0] and outs[1][0] == ""


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_mhd_twin(capsys, dtype):
    out = _example("torch_mhd_simulation").main([
        "--N", "16", "--steps", "5", "--device", "cpu", "--dtype", dtype])
    # the midpoint rule holds energy to O(dt^2) (2.1e-6 here in either
    # precision) and Theta's Casimirs to the working precision
    assert abs(out["energy_drift"]) <= 1e-5
    assert out["casimir_drift"] <= (1e-6 if dtype == "complex64" else 1e-12)
    assert "MagmpTorch steps" in capsys.readouterr().out
