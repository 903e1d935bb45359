"""quflow_tpu_torch.graphics and cluster against quflow_tpu's (twins of
tests/test_graphics_cluster.py): resample equal to quflow_tpu's on the
same numpy-seeded states, plot/spy/animation files written (headless), the
local cluster round trip through the port's runfile on the CPU."""

import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import quflow_tpu as qf
from quflow_tpu import graphics as jgraphics

import quflow_tpu_torch as qt
from quflow_tpu_torch import analysis, cluster, graphics

ROOT = Path(__file__).resolve().parent.parent


def smooth_W(N=16, lmax=8, seed=3):
    return qt.shr2mat(analysis.random_shr(lmax=lmax, seed=seed), N=N)


def test_resample_coeffs():
    omega = analysis.random_shr(lmax=7, seed=1)
    up = graphics.resample(omega, 16)
    assert up.shape == (256,)
    np.testing.assert_equal(up[:64], omega)
    np.testing.assert_array_equal(up, jgraphics.resample(omega, 16))
    down = graphics.resample(up, 8)
    np.testing.assert_equal(down, omega)


def test_resample_mat_and_fun():
    """mat, fun and tensor inputs resample as quflow_tpu resamples the
    numpy ones; a grid at its own N comes back as it is."""
    W = smooth_W()
    om = graphics.resample(W, 32)
    assert om.shape == (32**2,)
    np.testing.assert_allclose(om, jgraphics.resample(W, 32), atol=1e-12)
    np.testing.assert_array_equal(graphics.resample(torch.from_numpy(W), 32),
                                  om)
    f = qt.shr2fun(qt.mat2shr(W))
    f2 = graphics.resample(f, 32)
    assert f2.shape == (32, 63)
    np.testing.assert_allclose(f2, jgraphics.resample(f, 32), atol=1e-12)
    assert graphics.resample(f, 16) is f


def test_plot_projections(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    W = smooth_W()
    for i, proj in enumerate(("hammer", "mollweide", None)):
        im = qt.graphics.plot(torch.from_numpy(W) if i else W,
                              projection=proj, colorbar=True, time=1.0,
                              contours=True, title="t")
        assert im is not None
        path = tmp_path / f"plot{i}.png"
        im.figure.savefig(path)
        assert path.stat().st_size > 0
        plt.close("all")
    assert qt.plot2 is qt.plot
    with pytest.raises(ImportError, match="cartopy"):
        qt.plot(W, projection="orthographic")
    for r, n in ((1.5, 16), (0.7, None)):
        cmap = qt.adjust_colormap_brightness("RdBu_r", r, N=n)
        np.testing.assert_array_equal(
            cmap.colors,
            jgraphics.adjust_colormap_brightness("RdBu_r", r, N=n).colors)
    assert cmap.N == 256


def test_spy(tmp_path):
    import matplotlib.pyplot as plt

    im = graphics.spy(torch.from_numpy(smooth_W()))
    im.figure.savefig(tmp_path / "spy.png")
    assert (tmp_path / "spy.png").stat().st_size > 0
    plt.close("all")


def test_animation(tmp_path):
    out = str(tmp_path / "anim.mp4")
    states = torch.from_numpy(np.stack([smooth_W(seed=s) for s in range(3)]))
    path = graphics.create_animation(out, states, progress_bar=False)
    assert os.path.exists(path)
    assert os.path.getsize(path) > 0
    assert qt.create_animation2 is qt.create_animation


def test_animation_closes_its_progress_file(tmp_path, monkeypatch):
    """A progress file named by a string is opened and closed by
    create_animation (quflow_tpu's leaves it open)."""
    pytest.importorskip("tqdm")
    opened = []

    def recording_open(*args, **kwargs):
        f = open(*args, **kwargs)
        opened.append(f)
        return f

    monkeypatch.setattr(graphics, "open", recording_open, raising=False)
    states = [smooth_W(seed=s) for s in range(2)]
    graphics.create_animation(str(tmp_path / "a.gif"), states,
                              progress_file=str(tmp_path / "progress.txt"))
    assert len(opened) == 1 and opened[0].closed
    assert "frames" in (tmp_path / "progress.txt").read_text()


def test_import_needs_no_matplotlib_h5py_or_tqdm():
    """import quflow_tpu_torch with matplotlib, h5py and tqdm unimportable
    (the card's host has none of them)."""
    import subprocess

    code = ("import sys\n"
            "for m in ('matplotlib', 'h5py', 'tqdm'): sys.modules[m] = None\n"
            "import quflow_tpu_torch as qt\n"
            "assert qt.graphics and qt.cluster and qt.run_cluster\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _wait(filename, seconds=120):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if not cluster.status(filename, verbatim=False)["running"]:
            return
        time.sleep(0.5)
    cluster.delete(filename)
    raise AssertionError(f"the job ran past {seconds} s")


def test_cluster_local_roundtrip(tmp_path):
    """Launch a tiny simulation as a local background job of the port's
    runfile on the CPU, poll status, check the state advanced as
    quflow_tpu_torch's solve advances it in-process, delete.  The job has
    120 s."""
    from quflow_tpu_torch.sim import QuSimulation

    W = smooth_W(N=12, lmax=5)
    filename = str(tmp_path / "clustersim.hdf5")
    sim = QuSimulation(filename, overwrite=True, state=W)
    sim["stepsize"] = 0.1
    sim["steps"] = 20
    sim["steps_out"] = 10
    sim["progress_bar"] = False

    jobid = cluster.solve(filename, backend="local", device="cpu",
                          env={"PYTHONPATH": str(ROOT)})
    assert isinstance(jobid, int)
    _wait(filename)
    assert not cluster.status(filename, verbatim=False)["running"]

    log = (tmp_path / "clustersim_job.log").read_text()
    sim2 = QuSimulation(filename)
    assert sim2["step"][-1] == 20, f"job log:\n{log}"
    assert cluster.retrieve(filename) == os.path.abspath(filename)
    cluster.delete(filename, local=True)
    assert not (tmp_path / "clustersim_cluster.json").exists()


def test_cluster_job_needs_a_device(tmp_path):
    """Without device= the job asks for the CUDA device, and on a host
    without one it fails instead of running on the CPU."""
    from quflow_tpu_torch.sim import QuSimulation

    filename = str(tmp_path / "nodev.hdf5")
    sim = QuSimulation(filename, overwrite=True, state=smooth_W(N=8, lmax=3))
    sim["stepsize"] = 0.1
    sim["steps"] = 2
    sim["progress_bar"] = False
    env = {"PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    cluster.solve(filename, backend="local", env=env)
    _wait(filename)
    log = (tmp_path / "nodev_job.log").read_text()
    assert "device='cpu'" in log, log
    assert len(QuSimulation(filename)["step"]) == 1


def test_get_auto_cores():
    for N in (128, 512, 1024, 4096):
        assert cluster.get_auto_cores(N) == qf.cluster.get_auto_cores(N)
    assert cluster.get_auto_cores(1024) == 16


def test_run_cluster_passes_device(monkeypatch):
    seen = {}
    monkeypatch.setattr(cluster, "solve",
                        lambda *a, **kw: seen.update(args=a, kw=kw) or 7)
    assert qt.run_cluster("x.hdf5", 1.0, 0.5, 0.1, device="cpu") == 7
    assert seen["kw"] == dict(backend="local", simtime=1.0, dt_out=0.5,
                              stepsize=0.1, device="cpu")
