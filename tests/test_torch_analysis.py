"""quflow_tpu_torch's analysis and dynamics against quflow_tpu's: twins of
the spectra, scale_decomposition, gamma_ratio, project_el, blob and
legacy-solve cases of tests/test_physics_analysis.py, on the same numpy
inputs (and CPU tensors where the port takes them)."""

import numpy as np
import pytest
import torch

import quflow_tpu as qf
from quflow_tpu import analysis as ja
from quflow_tpu import dynamics as jd

import quflow_tpu_torch as qt
from quflow_tpu_torch import analysis as ta
from quflow_tpu_torch import dynamics as td
from quflow_tpu_torch import physics as tp

torch.set_num_threads(1)


def smooth_W(N=17, lmax=8, seed=3):
    omega = ta.random_shr(lmax=lmax, seed=seed)
    return qt.shr2mat(omega, N=N), omega


@pytest.mark.parametrize("kind", ["shr", "mat", "tensor"])
def test_spectra_match_and_sum_to_the_functionals(kind):
    """Parseval: the spectra sum to twice the energy and enstrophy, and
    equal quflow_tpu's, from coefficients, a matrix or a tensor."""
    W, omega = smooth_W()
    data = {"shr": omega, "mat": W, "tensor": torch.from_numpy(W)}[kind]
    jdata = omega if kind == "shr" else W
    el, espec = ta.energy_spectrum(data)
    el2, zspec = ta.enstrophy_spectrum(data)
    jel, jespec = ja.energy_spectrum(jdata)
    np.testing.assert_array_equal(el, jel)
    np.testing.assert_array_equal(el2, jel)
    np.testing.assert_allclose(espec, jespec, rtol=1e-12, atol=1e-16)
    np.testing.assert_allclose(zspec, ja.enstrophy_spectrum(jdata)[1],
                               rtol=1e-12, atol=1e-16)
    np.testing.assert_allclose(espec.sum() / 2,
                               float(tp.energy_euler(W, device="cpu")),
                               rtol=1e-10)
    np.testing.assert_allclose(zspec.sum() / 2, float(tp.enstrophy(W)),
                               rtol=1e-10)
    np.testing.assert_allclose(ta.energy_spectrum(omega, beta=1)[1],
                               ja.energy_spectrum(omega, beta=1)[1],
                               rtol=1e-12, atol=1e-16)


def test_scale_decomposition():
    W, _ = smooth_W()
    Ws, Wr = ta.scale_decomposition(W, device="cpu")
    np.testing.assert_allclose(Ws + Wr, W, atol=1e-12)
    P = qt.solve_poisson(W, skewh=True, device="cpu")
    assert np.abs(Ws @ P - P @ Ws).max() < 1e-10
    jWs, _ = ja.scale_decomposition(W)
    np.testing.assert_allclose(Ws, jWs, atol=1e-10)
    Wst, Wrt = ta.scale_decomposition(torch.from_numpy(W))
    assert isinstance(Wst, torch.Tensor)
    np.testing.assert_allclose(Wst.numpy(), Ws, atol=1e-10)
    np.testing.assert_allclose((Wst + Wrt).numpy(), W, atol=1e-12)


def test_random_shr_and_gamma_ratio():
    omega = ta.random_shr(lmax=31, s=1.0, gamma=0.0, seed=1)
    np.testing.assert_array_equal(
        omega, ja.random_shr(lmax=31, s=1.0, gamma=0.0, seed=1))
    assert np.all(omega[1:4] == 0.0)
    omega2 = ta.random_shr(lmax=31, s=1.0, gamma=0.5, seed=1)
    np.testing.assert_allclose(ta.gamma_ratio(omega2), 0.5, rtol=1e-10)
    W = qt.shr2mat(omega2, N=32)
    assert ta.gamma_ratio(W) == pytest.approx(ja.gamma_ratio(W), rel=1e-12)
    assert ta.gamma_ratio(torch.from_numpy(W)) == pytest.approx(
        ja.gamma_ratio(W), rel=1e-12)


def test_project_el_oracle():
    """The 1/N-normalized projection: N times it is the reference's
    output (quflow_tpu's test of the same oracle)."""
    d = np.load("tests/data/oracle.npz")
    N = 17
    W = qt.shr2mat(d["omega17"], N=N)
    np.testing.assert_allclose(N * td.project_el(W, el=5),
                               d["project_el_5"], atol=1e-11)


def test_project_el_is_projection():
    W, _ = smooth_W()
    P5 = td.project_el(W, el=5)
    np.testing.assert_allclose(td.project_el(P5, el=5), P5, atol=1e-12)
    np.testing.assert_allclose(td.project_el(W, el=5, complement=True) + P5,
                               W, atol=1e-12)
    np.testing.assert_allclose(qt.laplace(P5, skewh=True, device="cpu"),
                               -30.0 * P5, atol=1e-9)
    for el in (5, [2, 7], -3):
        np.testing.assert_allclose(td.project_el(W, el=el),
                                   jd.project_el(W, el=el), atol=1e-13)
    Pt = td.project_el(torch.from_numpy(W), el=[2, 7], complement=True)
    assert isinstance(Pt, torch.Tensor)
    np.testing.assert_allclose(Pt.numpy(),
                               jd.project_el(W, el=[2, 7], complement=True),
                               atol=1e-13)


def test_north_blob_oracle():
    d = np.load("tests/data/oracle.npz")
    np.testing.assert_allclose(td.north_blob(9, sigma=0.2, device="cpu"),
                               d["north_blob_9"], atol=1e-13)
    np.testing.assert_array_equal(td.north_blob(9), jd.north_blob(9))


def test_blob_matches_and_keeps_the_spectrum():
    pos = np.array([1.0, 1.0, 0.0])
    Wn = td.north_blob(16, sigma=0.1, device="cpu")
    Wb = td.blob(16, pos=pos, sigma=0.1, device="cpu")
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(-1j * Wb)),
                               np.sort(np.linalg.eigvalsh(-1j * Wn)),
                               atol=1e-12)
    np.testing.assert_allclose(Wb, jd.blob(16, pos=pos, sigma=0.1),
                               atol=1e-12)


def test_dynamics_legacy_solve():
    """The legacy loop: callbacks every inner_steps, and the state of
    quflow_tpu's loop."""
    W, _ = smooth_W(N=12, lmax=5)
    calls, jcalls = [], []
    out = td.solve(W.copy(), stepsize=0.1, steps=20, inner_steps=10,
                   callback=lambda W, inner_time=None, inner_steps=None:
                   calls.append(inner_steps),
                   progress_bar=False, device="cpu")
    ref = jd.solve(W.copy(), stepsize=0.1, steps=20, inner_steps=10,
                   callback=lambda W, inner_time=None, inner_steps=None:
                   jcalls.append(inner_steps), progress_bar=False)
    assert calls == jcalls == [10, 10]
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-12)
    with pytest.raises(ValueError, match="One, and only one"):
        td.solve(W.copy(), steps=2, time=1.0, progress_bar=False)


def test_top_level_names():
    assert qt.project_el is td.project_el and qt.blob is td.blob
    assert qt.scale_decomposition is ta.scale_decomposition
    assert qt.analysis is ta and qt.dynamics is td
    assert qf.dynamics.north_blob is jd.north_blob
