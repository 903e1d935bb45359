"""Persistence and restart on quflow_tpu_torch, the twins of
tests/test_simulation.py's restart tests, with ``solve``'s default
integrator ``isomp`` on the CPU: 50 + 50 steps through the file equal 100
straight steps bit for bit; resuming from the QuSimulation keeps its
stored arguments; a simulation file that quflow_tpu wrote with its device
integrator resumes on the port; the generated runfile."""

import ast
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import quflow_tpu as qf
from quflow_tpu.sim import QuSimulation as JQuSimulation
from quflow_tpu.sim import registry as jregistry

import quflow_tpu_torch as qt
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.sim import QuSimulation, registry, solve

pytest.importorskip("h5py")
torch.set_num_threads(1)


def get_random_mat(N=5, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    W -= W.conj().T
    return W


def test_solve_restart(tmp_path):
    """50+50 steps via the file round-trip equal 100 straight steps, with no
    integrator (the default isomp)."""
    W = get_random_mat(35)
    kw = dict(stepsize=0.1, steps_out=10, progress_bar=False, device="cpu")
    sim = QuSimulation(tmp_path / "testsim.hdf5", overwrite=True, state=W)
    solve(W.copy(), steps=50, callback=sim, **kw)

    sim2 = QuSimulation(tmp_path / "testsim.hdf5")
    solve(sim2["mat", -1], steps=50, callback=sim, **kw)

    sim3 = QuSimulation(tmp_path / "testsim3.hdf5", overwrite=True, state=W)
    solve(W.copy(), steps=100, callback=sim3, **kw)

    N = W.shape[-1]
    np.testing.assert_allclose(
        qt.qtime2seconds(1.0, N=N) * np.arange(11), sim["time"], rtol=1e-12)
    np.testing.assert_equal(10 * np.arange(11), sim["step"])
    np.testing.assert_equal(sim3["mat", -1], sim["mat", -1])


def test_solve_resume_from_sim(tmp_path):
    """Passing the QuSimulation itself resumes with its stored arguments."""
    W = get_random_mat(20)
    sim = QuSimulation(tmp_path / "testsim.hdf5", overwrite=True, state=W)
    sim["stepsize"] = 0.1
    sim["steps"] = 30
    sim["steps_out"] = 10
    solve(sim, progress_bar=False, device="cpu")
    assert sim["step"][-1] == 30
    solve(sim, progress_bar=False, device="cpu")
    assert sim["step"][-1] == 60
    t = sim["time"]
    np.testing.assert_allclose(np.diff(t), t[1] - t[0])


@pytest.mark.parametrize("name,cls", [("isomp_tpu", tst.IsompTorch),
                                      ("magmp_tpu", tst.MagmpTorch)])
def test_quflow_tpu_names_resolve(name, cls):
    fn = registry.resolve(name)
    assert fn is registry.resolve(name.replace("_tpu", "_torch"))
    # the same registrable contract: a warm instance, and no silent drop
    with pytest.raises(TypeError, match="tol"):
        S = np.zeros((2, 4, 4) if cls is tst.MagmpTorch else (4, 4), complex)
        fn(S, 0.1, steps=1, tol=1e-8, device="cpu")


def test_resume_file_quflow_tpu_wrote(tmp_path, monkeypatch):
    """quflow_tpu writes a simulation that steps with its device integrator
    (``isomp_tpu``, complex64, maxit 5); the port resumes it by name and
    takes the same 20 steps as quflow_tpu does: complex64 within 5e-5 of
    the largest entry (the two packages' float32 solves round apart, as
    tests/test_torch_stepper.py::test_step_fn_matches_jax_10_steps).  Both
    packages' warm integrator instances start cold."""
    monkeypatch.setattr(registry, "_WARM", {})
    monkeypatch.setattr(jregistry, "_ISOMP_TPU", None, raising=False)
    N = 16
    W = get_random_mat(N, seed=3)
    path = str(tmp_path / "jaxsim.hdf5")
    jsim = JQuSimulation(path, overwrite=True, state=W)
    jsim["stepsize"] = 0.1
    jsim["steps"] = 20
    jsim["steps_out"] = 10
    jsim["integrator"] = jregistry.resolve("isomp_tpu")
    qf.solve(jsim, progress_bar=False)
    assert jsim["step"][-1] == 20

    tsim = QuSimulation(path)  # the port opens the file quflow_tpu wrote
    assert tsim["integrator"] is registry.isomp_torch
    np.testing.assert_array_equal(tsim["mat", -1], jsim["mat", -1])
    solve(tsim, progress_bar=False, device="cpu")
    assert list(tsim["step"]) == [0, 10, 20, 30, 40]
    Wt = tsim["mat", -1]

    # quflow_tpu resumes the same state from its own copy of the file
    shutil.copy(path, tmp_path / "jaxsim2.hdf5")
    jsim2 = JQuSimulation(str(tmp_path / "jaxsim2.hdf5"))
    # back to the state at step 20: the port appended two outputs
    monkeypatch.setattr(jregistry, "_ISOMP_TPU", None)
    Wj = qf.solve(np.asarray(jsim2["mat", 2]), stepsize=0.1, steps=20,
                  steps_out=10, progress_bar=False,
                  integrator=jregistry.resolve("isomp_tpu"))
    assert np.abs(Wt - Wj).max() <= 5e-5 * np.abs(Wj).max()
    np.testing.assert_allclose(tsim["time"], jsim2["time"], rtol=1e-12)


def _run_runfile(path, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [str(path)] + argv)
    monkeypatch.chdir(path.parent)
    runpy.run_path(str(path), run_name="__main__")


def test_create_runfile(tmp_path, monkeypatch):
    """The runfile parses, names quflow_tpu_torch and not JAX, steps with
    IsompTorch on --device, and without a card and without --device it
    raises instead of choosing the CPU."""
    W = get_random_mat(16).astype(np.complex64)
    sim = QuSimulation(tmp_path / "mysim.hdf5", overwrite=True, state=W)
    sim["stepsize"] = 0.1
    sim["steps"] = 10
    sim["steps_out"] = 5
    path = qt.create_runfile(sim)
    assert path == str(tmp_path / "mysim_runfile.py")
    assert qt.simulation.create_runfile is qt.create_runfile
    content = open(path).read()
    assert "mysim" in content and "argparse" in content
    assert "quflow_tpu_torch" in content and "--device" in content
    assert "jax" not in content
    ast.parse(content)  # the generated runfile is valid python

    _run_runfile(Path(path), ["--device", "cpu", "--maxit", "3"],
                 monkeypatch)
    assert list(QuSimulation(tmp_path / "mysim.hdf5")["step"]) == [0, 5, 10]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run_runfile(Path(path), [], monkeypatch)
