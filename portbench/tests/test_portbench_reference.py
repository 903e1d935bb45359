"""The plain reference against quflow_tpu_torch at small N on the CPU:
the Laplacian and its Poisson solve, the initial-state map, and a few
steps of both schemes."""

import numpy as np
import pytest
import torch

import quflow_tpu_torch as qf
from portbench.reference.initial import (basis_columns, coefficients_of,
                                         state_matrix, states)
from portbench.reference.quantized import Laplacian, hbar
from portbench.reference import isomp, magmp
from portbench.reference.scheme import auto_tol

SCHEMES = {"isomp": isomp.Scheme, "magmp": magmp.Scheme}


def _skewh(N, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    return A - A.conj().T


@pytest.mark.parametrize("N", [5, 16, 33, 64])
def test_laplacian_and_poisson(N):
    lap = Laplacian(N)
    W = _skewh(N, N)
    got = lap.apply(torch.from_numpy(W)).numpy()
    want = qf.laplace(W, device="cpu")
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    P = lap.solve(torch.from_numpy(W)).numpy()
    Pq = qf.solve_poisson(W, device="cpu")
    assert np.abs(P - Pq).max() <= 1e-12 * np.abs(Pq).max()
    assert abs(np.trace(P)) <= 1e-12


@pytest.mark.parametrize("N", [16, 33])
def test_initial_state_map(N):
    omega = coefficients_of(np.random.default_rng(N), 10)
    W = state_matrix(omega, N, basis_columns(N, 10))
    Wq = qf.shr2mat(omega, N=N)
    assert np.abs(W - Wq).max() <= 1e-13
    assert np.abs(W + W.conj().T).max() == 0


def test_states_repeat_for_a_seed_and_differ_by_member():
    a = states(2 ** 32 + 3, 16, 10, members=2)
    assert np.array_equal(a, states(2 ** 32 + 3, 16, 10, members=2))
    assert not np.allclose(a[0], a[1])
    assert not np.allclose(a, states(-(2 ** 32 + 3), 16, 10, members=2))


def _run(integrator, X, steps=10):
    return qf.solve(torch.from_numpy(X.copy()), stepsize=0.25, steps=steps,
                    steps_out=steps, integrator=integrator,
                    progress_bar=False)


@pytest.mark.parametrize("dtype,maxit,tol", [(np.complex128, 25, 1e-11),
                                             (np.complex64, 5, 5e-6)])
@pytest.mark.parametrize("kind", ["isomp", "magmp"])
def test_scheme_follows_the_port(kind, dtype, maxit, tol):
    N = 24
    S0 = states(11, N, 10, components=2, scales=(1.0, 0.1))[0]
    X0 = S0[0] if kind == "isomp" else S0
    cls = qf.IsompTorch if kind == "isomp" else qf.MagmpTorch
    out = _run(cls(maxit=maxit, dtype=dtype, device="cpu"),
               X0.astype(dtype))
    ref, counts = SCHEMES[kind](N).run(torch.from_numpy(X0),
                                       0.25 * hbar(N), 10)
    change = (ref - torch.from_numpy(X0)).abs().amax()
    gap = (out.to(torch.complex128) - ref).abs().amax() / change
    assert gap <= tol
    assert min(counts) >= 3


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_adaptive_rule_follows_isomp(dtype):
    N = 24
    W0 = states(12, N, 10)[0, 0].astype(dtype)
    seen = []
    out = qf.solve(torch.from_numpy(W0.copy()), stepsize=0.25, steps=10,
                   steps_out=10, progress_bar=False,
                   callback=lambda W, **kw: seen.append(kw["iterations"]))
    X0 = torch.from_numpy(W0.astype(np.complex128))
    dt = 0.25 * hbar(N)
    ref, counts = isomp.Scheme(N).run(
        X0, dt, 10, rule="adaptive", maxit=10, minit=1,
        tol=auto_tol(X0, dt, N, np.dtype(dtype)))
    assert seen[0] * 10 == sum(counts)
    gap = (out.to(torch.complex128) - ref).abs().amax() / (ref - X0).abs().amax()
    assert gap <= (1e-12 if dtype == np.complex128 else 5e-6)
