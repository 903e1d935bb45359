"""The physics functionals and the norms of quflow_tpu_torch against
quflow_tpu on the same numpy inputs: the contract of
tests/test_physics_analysis.py and tests/test_oracle_parity.py
(sectional curvature against the reference-run oracle), each also held
against quflow_tpu's own value, on numpy and on tensors."""

from pathlib import Path

import numpy as np
import pytest
import torch

import quflow_tpu as qf
from quflow_tpu import analysis as janalysis
from quflow_tpu import physics as jphysics

import quflow_tpu_torch as qt
from quflow_tpu_torch import physics
from quflow_tpu_torch.ops import geometry

torch.set_num_threads(1)

ORACLE = Path(__file__).resolve().parent / "data" / "oracle.npz"


def smooth_W(N=17, lmax=8, seed=3):
    omega = qt.random_shr(lmax=lmax, seed=seed)
    return qt.shr2mat(omega, N=N), omega


def _rand_skewh(N, rng):
    A = rng.randn(N, N) + 1j * rng.randn(N, N)
    A -= A.conj().T
    return A - np.eye(N) * np.trace(A) / N


def test_energy_enstrophy_vs_spectra():
    """Parseval: the sums of the spectra equal the quadratic functionals;
    the same values as quflow_tpu's."""
    W, omega = smooth_W()
    el, espec = janalysis.energy_spectrum(omega)
    el, zspec = janalysis.enstrophy_spectrum(omega)
    E = float(physics.energy_euler(W, device="cpu"))
    Z = float(physics.enstrophy(W))
    np.testing.assert_allclose(espec.sum() / 2, E, rtol=1e-10)
    np.testing.assert_allclose(zspec.sum() / 2, Z, rtol=1e-10)
    assert E == pytest.approx(float(jphysics.energy_euler(W)), rel=1e-13)
    assert Z == float(jphysics.enstrophy(W))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_inner_H1_Hm1(kind):
    """The Sobolev inner products and norms against quflow_tpu's; a tensor
    in gives a tensor out."""
    W, _ = smooth_W()
    P = np.array(qf.solve_poisson(W, skewh=True))  # writeable
    x = (lambda A: A) if kind == "numpy" else torch.from_numpy
    kw = {"device": "cpu"} if kind == "numpy" else {}
    values = {
        "inner_Hm1": (physics.inner_Hm1(x(W), x(W), **kw),
                      jphysics.inner_Hm1(W, W)),
        "norm_Hm1": (physics.norm_Hm1(x(W), **kw), jphysics.norm_Hm1(W)),
        "inner_H1": (physics.inner_H1(x(P), x(P), **kw),
                     jphysics.inner_H1(P, P)),
        "norm_H1": (physics.norm_H1(x(P), **kw), jphysics.norm_H1(P)),
        "energy_euler": (physics.energy_euler(x(W), **kw),
                         jphysics.energy_euler(W)),
    }
    for name, (got, ref) in values.items():
        assert isinstance(got, torch.Tensor) == (kind == "tensor"), name
        assert float(got) == pytest.approx(float(ref), rel=1e-12), name
    np.testing.assert_allclose(float(values["inner_Hm1"][0]),
                               float(-qt.inner_L2(W, P)), rtol=1e-12)
    np.testing.assert_allclose(float(values["norm_H1"][0]) ** 2,
                               float(-qt.inner_L2(P, W)), rtol=1e-10)


def test_energy_conserved_enstrophy_exact():
    W, _ = smooth_W(N=16)
    dt = 0.1 * qt.hbar(16)
    W1 = qt.isomp(W.copy(), dt, 200, tol=1e-12, maxit=20, device="cpu")
    np.testing.assert_allclose(float(physics.enstrophy(W1)),
                               float(physics.enstrophy(W)), rtol=1e-12)
    np.testing.assert_allclose(float(physics.energy_euler(W1, device="cpu")),
                               float(physics.energy_euler(W, device="cpu")),
                               rtol=1e-6)


def test_sectional_curvature_parity():
    """The reference-run oracle to 1e-10 (tests/test_oracle_parity.py)."""
    d = np.load(ORACLE)
    K = physics.sectional_curvature(d["curv_F"], d["curv_G"], device="cpu")
    np.testing.assert_allclose(float(K), float(d["curv_K"]), rtol=1e-10)


def test_sectional_curvature_symmetry_and_kinds():
    """K(F,G) == K(G,F); quflow_tpu's value; a tensor pair gives a
    tensor."""
    rng = np.random.RandomState(5)
    F, G = _rand_skewh(12, rng), _rand_skewh(12, rng)
    K = float(physics.sectional_curvature(F, G, device="cpu"))
    np.testing.assert_allclose(
        K, float(physics.sectional_curvature(G, F, device="cpu")), rtol=1e-8)
    assert K == pytest.approx(float(jphysics.sectional_curvature(F, G)),
                              rel=1e-10)
    Kt = physics.sectional_curvature(torch.from_numpy(F), torch.from_numpy(G))
    assert isinstance(Kt, torch.Tensor)
    assert float(Kt) == pytest.approx(K, rel=1e-13)


@pytest.mark.parametrize("name", ["norm_Linf", "norm_L1", "integral",
                                  "project_skewherm", "norm_L2"])
def test_norms_and_projection(name):
    """The geometry functions against quflow_tpu's, numpy and tensors,
    single and stacked states."""
    rng = np.random.RandomState(7)
    A = rng.randn(10, 10) + 1j * rng.randn(10, 10)
    for X in (A, np.stack([A, 2 * A])):
        if name == "norm_Linf" and X.ndim > 2:
            continue  # quflow_tpu's numpy branch takes one matrix
        ref = np.asarray(getattr(qf.ops.geometry, name)(X))
        got = getattr(geometry, name)(X)
        assert isinstance(got, (np.ndarray, np.floating))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
        got_t = getattr(geometry, name)(torch.from_numpy(X))
        assert isinstance(got_t, torch.Tensor)
        np.testing.assert_allclose(got_t.numpy(), ref, rtol=1e-12,
                                   atol=1e-14)
    assert getattr(qt, name, None) in (None, getattr(geometry, name))
