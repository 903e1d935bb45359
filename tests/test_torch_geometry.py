"""quflow_tpu_torch's geometry against quflow_tpu's: twins of
tests/test_geometry.py (norms, inner products, the Hoppe-Yau Laplacian
identity, the so(3) algebra and the generators' scalings and spectral
norms, rotation against the oracle) and tests/test_dia_fastpath.py (the
banded dia_matrix paths), on numpy input and on CPU tensors."""

import numpy as np
import pytest
import torch
from scipy.sparse import dia_matrix

import quflow_tpu as qf

import quflow_tpu_torch as qt
from quflow_tpu_torch.ops import geometry as tg

torch.set_num_threads(1)


def random_omega(N, seed, complex_=False):
    rng = np.random.RandomState(seed)
    om = rng.randn(N**2)
    return om + 1j * rng.randn(N**2) if complex_ else om


def random_mat(N=5, seed=3):
    rng = np.random.RandomState(seed)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    W -= W.conj().T
    return W


@pytest.mark.parametrize("N", [5, 17])
def test_norm_L2_isometry(N):
    omega = random_omega(N, 1)
    W = qt.shr2mat(omega, N=N)
    np.testing.assert_allclose(np.linalg.norm(omega), float(qt.norm_L2(W)))
    np.testing.assert_allclose(float(qt.norm_L2(torch.from_numpy(W))),
                               float(qf.norm_L2(W)), rtol=1e-13)


@pytest.mark.parametrize("N,complex_", [(5, False), (17, False), (64, False),
                                        (17, True), (64, True)])
def test_inner_L2(N, complex_):
    o1, o2 = random_omega(N, 11, complex_), random_omega(N, 12, complex_)
    to_mat = qt.shc2mat if complex_ else qt.shr2mat
    W1, W2 = to_mat(o1, N=N), to_mat(o2, N=N)
    np.testing.assert_allclose((o1 * o2.conj()).sum().real,
                               float(qt.inner_L2(W1, W2)))
    np.testing.assert_allclose(
        float(qt.inner_L2(torch.from_numpy(W1), torch.from_numpy(W2))),
        float(qf.inner_L2(W1, W2)), rtol=1e-12)


@pytest.mark.parametrize("N", [17, 64])
def test_inner_vs_norm_L2_and_Linf(N):
    W = random_mat(N)
    np.testing.assert_allclose(float(qt.norm_L2(W)),
                               np.sqrt(float(qt.inner_L2(W, W))))
    np.testing.assert_allclose(float(qt.norm_Linf(W)),
                               np.linalg.norm(W, ord=2))


@pytest.mark.parametrize("N", [15, 16, 64])
def test_hoppe_yau_laplacian(N):
    """Delta_N P = sum_k (1/hbar^2) [X_k, [X_k, P]], on numpy and on a
    tensor."""
    P = random_mat(N)
    X = qt.cartesian_generators(N)
    lhs = sum(qt.bracket(Xk, qt.bracket(Xk, P)) for Xk in X)
    W = qt.laplace(P, skewh=True, device="cpu")
    np.testing.assert_allclose(lhs, W, atol=1e-10 * N)
    Pt = torch.from_numpy(P)
    g = qt.grad(Pt)
    assert g.shape == (3, N, N)
    lhs_t = sum(qt.bracket(torch.from_numpy(Xk), g[k])
                for k, Xk in enumerate(X))
    np.testing.assert_allclose(lhs_t.numpy(), W, atol=1e-10 * N)


@pytest.mark.parametrize("N", [15, 16, 64, 128])
def test_so3_and_cartesian_generators(N):
    S1, S2, S3 = qt.so3_generators(N)
    for a, b in zip((S1, S2, S3), qf.so3_generators(N)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(S1 @ S2 - S2 @ S1, S3, atol=1e-13)
    np.testing.assert_allclose(S2 @ S3 - S3 @ S2, S1, atol=1e-13)
    np.testing.assert_allclose(S3 @ S1 - S1 @ S3, S2, atol=1e-13)
    X1, X2, X3 = qt.cartesian_generators(N)
    np.testing.assert_allclose(qt.bracket(X1, X2), X3, atol=1e-13)
    np.testing.assert_allclose(qt.bracket(X2, X3), X1, atol=1e-13)
    np.testing.assert_allclose(qt.bracket(X3, X1), X2, atol=1e-13)
    assert qt.so3_generators(N, np.complex64)[0].dtype == np.complex64


@pytest.mark.parametrize("N", [15, 16, 64])
def test_cartesian_generators_scale(N):
    X1, X2, X3 = qt.cartesian_generators(N)
    T = [qt.shr2mat(np.eye(4)[k], N=N) for k in (1, 2, 3)]
    np.testing.assert_allclose(np.sqrt(3) * X1, T[2], atol=1e-14)
    np.testing.assert_allclose(np.sqrt(3) * X2, T[0], atol=1e-14)
    np.testing.assert_allclose(np.sqrt(3) * X3, T[1], atol=1e-14)


@pytest.mark.parametrize("N, ref", [(64, 0.98449518), (45, 0.97801929),
                                    (128, 0.99221778)])
def test_cartesian_generators_spectrum(N, ref):
    for Xi in qt.cartesian_generators(N):
        np.testing.assert_allclose(float(qt.norm_Linf(Xi)), ref, atol=1e-8)


def test_rotate_oracle():
    d = np.load("tests/data/oracle.npz")
    W9, xi = d["smooth_W9"], d["rotate_xi"]
    np.testing.assert_allclose(qt.rotate(xi, W9), d["rotate_W9"], atol=1e-12)
    out = qt.rotate(xi, torch.from_numpy(W9))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), d["rotate_W9"], atol=1e-12)
    np.testing.assert_allclose(qt.rotate(xi, W9), np.asarray(qf.rotate(xi, W9)),
                               atol=1e-13)


def test_grad_and_integral_match():
    P = random_mat(12, seed=8)
    np.testing.assert_allclose(qt.grad(P), np.asarray(qf.grad(P)), atol=1e-12)
    np.testing.assert_allclose(float(qt.integral(P)), float(qf.integral(P)))


# the banded dia_matrix paths (tests/test_dia_fastpath.py)

def test_matmul_dia_matches_dense():
    """Banded dia product = dense product, junk outside the matrix bounds
    of the dia storage included; the same as quflow_tpu's."""
    from quflow_tpu.ops.geometry import matmul_dia as jmatmul_dia

    rng = np.random.RandomState(7)
    N = 40
    for _ in range(5):
        ka = rng.choice(np.arange(-6, 7), size=rng.randint(1, 5),
                        replace=False)
        kb = rng.choice(np.arange(-6, 7), size=rng.randint(1, 5),
                        replace=False)
        A = dia_matrix((rng.randn(len(ka), N) + 1j * rng.randn(len(ka), N),
                        ka), shape=(N, N))
        B = dia_matrix((rng.randn(len(kb), N) + 1j * rng.randn(len(kb), N),
                        kb), shape=(N, N))
        C = tg.matmul_dia(A, B)
        assert C.format == "dia"
        np.testing.assert_allclose(C.toarray(), A.toarray() @ B.toarray(),
                                   atol=1e-12)
        np.testing.assert_array_equal(C.toarray(),
                                      jmatmul_dia(A, B).toarray())


def test_bracket_dia_uses_banded_path():
    N = 24
    P = qt.elmr2mat(2, 1, N=N)
    W = qt.elmr2mat(3, -2, N=N)
    out = qt.bracket(P, W)
    assert out.format == "dia"
    np.testing.assert_allclose(out.toarray(),
                               qt.bracket(P.toarray(), W.toarray()),
                               atol=1e-12)
    assert np.abs(out.offsets).max() <= (np.abs(P.offsets).max()
                                         + np.abs(W.offsets).max())
    np.testing.assert_allclose(out.toarray(), qf.bracket(P, W).toarray(),
                               atol=1e-14)


def test_norms_dia():
    T = qt.elmr2mat(5, 2, 19)
    np.testing.assert_allclose(float(qt.norm_L2(T)), 1.0, rtol=1e-12)
    np.testing.assert_allclose(float(qt.inner_L2(T, T)), 1.0, rtol=1e-12)
