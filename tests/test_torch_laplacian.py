"""The Poisson family of quflow_tpu_torch (ops/laplacian.py, solved on the
shear layout through the column-solve selector) and its compatibility
package against quflow_tpu's row-packed backend, on the same numpy inputs:
the contract of tests/test_laplacian.py, tests/test_laplacian_compat.py
and tests/test_dia_fastpath.py, each case also held within 1e-13 relative
of quflow_tpu; the skew-Hermitian mirroring, ``reduce``, dia matrices, the
devices, complex64, and the operators bit for bit."""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.sparse import dia_matrix

import quflow_tpu as qf
from quflow_tpu import laplacian as jlap
from quflow_tpu.ops import laplacian as jl

import quflow_tpu_torch as qt
from quflow_tpu_torch import laplacian as tlap
from quflow_tpu_torch.ops import diagpack, shear_solve, tridiag
from quflow_tpu_torch.ops import laplacian as tl
from quflow_tpu_torch.ops.cuda_scan_solve import shear_scan_reference
from quflow_tpu_torch.ops.cuda_solve import shear_thomas_reference

torch.set_num_threads(1)

ORACLE = Path(__file__).resolve().parent / "data" / "oracle.npz"

#: (family, positional args after W or before it, keyword args)
FAMILIES = {
    "poisson": lambda m, W, **kw: m.solve_poisson(W, **kw),
    "heat": lambda m, W, **kw: m.solve_heat(1e-2 * 0.1, W, **kw),
    "helmholtz": lambda m, W, **kw: m.solve_helmholtz(W, alpha=0.1, **kw),
    "viscdamp": lambda m, W, **kw: m.solve_viscdamp(
        0.1, W, nu=1e-2, alpha=0.6, theta=1, **kw),
    "viscdamp_cn": lambda m, W, **kw: m.solve_viscdamp(
        0.1, W, nu=1e-2, alpha=0.6, theta=0.5, **kw),
    "globalqg": lambda m, W, **kw: m.solve_globalqg(W, gamma=0.7, **kw),
    "laplace": lambda m, W, **kw: m.laplace(W, **kw),
}


@pytest.fixture(scope="module")
def oracle():
    return np.load(ORACLE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _t(fn, *args, **kw):
    """The port's function on the CPU."""
    return fn(*args, device="cpu", **kw)


def get_random_mat(N=5, zero_trace=True, skewh=True, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    if skewh:
        W -= W.conj().T
    if zero_trace:
        W -= np.eye(N) * np.trace(W) / N
    return W


def get_random_poisson_solution(N=5, skewh=True, seed=None, lmax=None,
                                zerotrace=True):
    rng = np.random.RandomState(seed)
    if lmax is None:
        lmax = N
    lmax = min(lmax, N)
    if skewh:
        omegaP = rng.randn(lmax**2)
    else:
        omegaP = rng.randn(lmax**2) + 1.0j * rng.randn(lmax**2)
    omegaW = omegaP.copy()
    ells = qf.ind2elm(np.arange(lmax**2))[0][1:]
    omegaW[1:] *= -ells * (ells + 1)
    if zerotrace:
        omegaW[0] = 0.0
    omegaP[0] = 0.0
    sh2mat = qf.shr2mat if skewh else qf.shc2mat
    return sh2mat(omegaP, N=N), sh2mat(omegaW, N=N)


def get_smooth_mat(N):
    return qf.shr2mat(np.load(ORACLE)["smooth_omegar"], N=N)


# ---------------------------------------------------------------------------
# tests/test_laplacian.py on the port, each also against quflow_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [2, 33, 65, 128])
@pytest.mark.parametrize("skewh", [True, False])
def test_laplace(N, skewh):
    Pexact, Wexact = get_random_poisson_solution(N=N, skewh=skewh, seed=N)
    W = _t(tl.laplace, Pexact, skewh=skewh)
    assert isinstance(W, np.ndarray) and W.dtype == np.complex128
    np.testing.assert_allclose(W, Wexact, atol=1e-11 * N**2)
    assert _rel(W, np.asarray(jl.laplace(Pexact, skewh=skewh))) <= 1e-13


@pytest.mark.parametrize("N", [33, 64, 101])
@pytest.mark.parametrize("skewh", [True, False])
@pytest.mark.parametrize("zerotrace", [True, False])
def test_solve_poisson(N, skewh, zerotrace):
    Pexact, Wexact = get_random_poisson_solution(
        N=N, skewh=skewh, seed=N + 1, zerotrace=zerotrace
    )
    P = _t(tl.solve_poisson, Wexact, skewh=skewh)
    np.testing.assert_allclose(P, Pexact, atol=1e-14 * N**2, rtol=0)
    J = np.asarray(jl.solve_poisson(Wexact, skewh=skewh))
    # every diagonal but the main one within 1e-13 of quflow_tpu.  The main
    # diagonal is the m=0 system, whose condition grows as N^2: there the
    # serial Thomas solve and quflow_tpu's affine scan differ by up to
    # 1.2e-13 at N=101, while each is 2e-13 from the exact solution, so
    # it is held within quflow_tpu's own distance from the exact solution.
    off = ~np.eye(N, dtype=bool)
    assert np.abs(P - J)[off].max() <= 1e-13 * np.abs(J).max()
    assert _rel(P, J) <= max(1e-13, _rel(J, Pexact))


def test_solve_poisson_autodetect():
    Pexact, Wexact = get_random_poisson_solution(N=33, skewh=True, seed=5)
    P = _t(tl.solve_poisson, Wexact)  # skewh auto-detected
    np.testing.assert_allclose(P, Pexact, atol=1e-14 * 33**2, rtol=0)
    # and a general matrix is detected as such
    W = get_random_mat(33, skewh=False, seed=6)
    assert _rel(_t(tl.solve_poisson, W),
                np.asarray(jl.solve_poisson(W, skewh=False))) <= 1e-13


def test_solve_poisson_oracle(oracle):
    P = _t(tl.solve_poisson, oracle["isomp_W0"], skewh=True)
    np.testing.assert_allclose(P, oracle["poisson_P"], atol=1e-13)


@pytest.mark.parametrize("N", [33, 64, 101])
def test_solve_poisson_multistate(N):
    """Stacked states: reduce='first' solves state 0 and broadcasts it."""
    W = np.stack([get_smooth_mat(N), get_random_mat(N, seed=N)])
    Plarge = _t(tl.solve_poisson, W, skewh=True)
    P0 = _t(tl.solve_poisson, W[0], skewh=True)
    np.testing.assert_allclose(Plarge, np.broadcast_to(P0, W.shape))
    assert _rel(Plarge, np.asarray(jl.solve_poisson(W, skewh=True))) <= 1e-13


@pytest.mark.parametrize("N", [33, 65, 128])
@pytest.mark.parametrize("skewh", [True, False])
def test_solve_helmholtz(N, skewh, alpha=0.1):
    rng = np.random.RandomState(22)
    lmax = 16
    if skewh:
        omegaP = rng.randn(lmax**2)
    else:
        omegaP = rng.randn(lmax**2) + 1.0j * rng.randn(lmax**2)
    omegaW = omegaP.copy()
    ells = qf.ind2elm(np.arange(lmax**2))[0][1:]
    omegaW[1:] *= 1.0 + alpha * ells * (ells + 1)
    omegaW[0] = 0.0
    omegaP[0] = 0.0
    sh2mat = qf.shr2mat if skewh else qf.shc2mat
    W = sh2mat(omegaW, N=N)
    Pexact = sh2mat(omegaP, N=N)
    P = _t(tl.solve_helmholtz, W, alpha=alpha, skewh=skewh)
    np.testing.assert_allclose(P, Pexact, atol=1e-12)
    assert _rel(P, np.asarray(jl.solve_helmholtz(W, alpha=alpha,
                                                 skewh=skewh))) <= 1e-13


@pytest.mark.parametrize("N", [9, 32])
def test_solve_heat_vs_viscdamp(N):
    W0 = get_smooth_mat(N)
    Wheat = W0.copy()
    Wviscdamp = W0.copy()
    for _ in range(100):
        Wheat = _t(tl.solve_heat, 1e-2 * 0.1, Wheat)
        Wviscdamp = _t(tl.solve_viscdamp, 0.1, Wviscdamp, nu=1e-2, alpha=0,
                       theta=1)
    np.testing.assert_allclose(Wheat, Wviscdamp)


def test_solve_heat_oracle(oracle):
    Wh = _t(tl.solve_heat, 1e-3, oracle["smooth_W9"])
    np.testing.assert_allclose(Wh, oracle["heat_W9"], atol=1e-13)
    assert _rel(Wh, np.asarray(jl.solve_heat(1e-3, oracle["smooth_W9"]))
                ) <= 1e-13


def test_solve_viscdamp_oracle(oracle):
    """100 theta-scheme steps against the reference-run oracle and against
    quflow_tpu's 100 steps."""
    Wt = oracle["smooth_W9"].copy()
    Wj = oracle["smooth_W9"].copy()
    for _ in range(100):
        Wt = _t(tl.solve_viscdamp, 0.1, Wt, nu=1e-2, alpha=0.6, theta=0.7)
        Wj = np.asarray(jl.solve_viscdamp(0.1, Wj, nu=1e-2, alpha=0.6,
                                          theta=0.7))
    np.testing.assert_allclose(
        qt.mat2shr(Wt), oracle["viscdamp_omegatref"], atol=1e-10, rtol=0
    )
    assert _rel(Wt, Wj) <= 1e-13


def test_solve_globalqg_oracle(oracle):
    P = _t(tl.solve_globalqg, oracle["smooth_W9"], gamma=0.7, skewh=True)
    np.testing.assert_allclose(P, oracle["globalqg_P9"], atol=1e-12)


def test_solve_globalqg_residual():
    """Up to the trace projection (which shifts the solution by c*I with
    A(I) = -gamma Z^2), the qg solve satisfies
    Delta P - (gamma/2)(Z^2 P + P Z^2) = W + c * gamma * Z^2."""
    N = 33
    gamma = 0.7
    W = get_random_mat(N, seed=2)
    P = _t(tl.solve_globalqg, W, gamma=gamma, skewh=True)
    assert _rel(P, np.asarray(jl.solve_globalqg(W, gamma=gamma, skewh=True))
                ) <= 1e-13
    s = (N - 1) / 2
    Z = np.diag(qt.hbar(N) * np.arange(-s, s + 1))
    resid = _t(tl.laplace, P, skewh=True) - (gamma / 2) * (
        Z @ Z @ P + P @ Z @ Z
    ) - W
    z2 = np.diag(Z @ Z)
    r = np.diag(resid)
    c = (r @ z2) / (z2 @ z2)
    np.testing.assert_allclose(resid, np.diag(c * z2), atol=1e-10)


# ---------------------------------------------------------------------------
# what the shear layout must reproduce of the row-packed one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("N", [16, 33])
def test_skewh_on_a_general_matrix_mirrors_the_lower_triangle(family, N):
    """skewh=True on a matrix that is not skew-Hermitian: quflow_tpu reads
    the lower triangle and the diagonal and mirrors them; so does the
    port's rebuild after its solve of both triangles."""
    W = get_random_mat(N, zero_trace=False, skewh=False, seed=N)
    got = FAMILIES[family](tl, W, skewh=True, device="cpu")
    ref = np.asarray(FAMILIES[family](jl, W, skewh=True))
    assert _rel(got, ref) <= 1e-13
    off = got - np.diag(np.diag(got))
    np.testing.assert_array_equal(off, -off.conj().T)


def test_skewh_result_is_exactly_skew_hermitian():
    W = get_random_mat(64, seed=3)
    P = _t(tl.solve_poisson, W, skewh=True)
    assert np.abs(P + P.conj().T).max() == 0.0


@pytest.mark.parametrize("reduce", ["first", "sum", "none", "select_first",
                                    "select_sum", "custom"])
def test_reduce(reduce):
    """The reduce policies on numpy and on tensors, against quflow_tpu;
    'first' broadcasts a view (``expand`` of a tensor)."""
    N = 17
    W = np.stack([get_random_mat(N, seed=s) for s in (1, 2, 3)])
    policy = {"select_first": (tl.select_first, jl.select_first),
              "select_sum": (tl.select_sum, jl.select_sum),
              "custom": (lambda A: A[1], lambda A: A[1])}.get(
                  reduce, (reduce, reduce))
    ref = np.asarray(jl.solve_poisson(W, skewh=True, reduce=policy[1]))
    got = _t(tl.solve_poisson, W, skewh=True, reduce=policy[0])
    assert isinstance(got, np.ndarray) and got.shape == W.shape
    assert _rel(got, ref) <= 1e-13
    if reduce in ("select_first", "select_sum"):
        return  # host policies of numpy arrays, as in quflow_tpu
    got_t = tl.solve_poisson(torch.from_numpy(W), skewh=True, reduce=policy[0])
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), got)
    if reduce == "first":
        assert got_t.stride()[0] == 0  # a view, not a copy
    with pytest.raises(ValueError):
        _t(tl.solve_poisson, W, skewh=True, reduce="median")


@pytest.mark.parametrize("m", [0, 9, 22])
@pytest.mark.parametrize("N", [33, 65])
def test_dia_matrices(N, m):
    """scipy dia matrices keep their offsets (tests/test_dia_fastpath.py),
    and equal quflow_tpu's."""
    def extract_dia(A):
        if m == 0:
            return dia_matrix((np.diagonal(A, 0), 0), shape=(N, N))
        data = np.zeros((2, N), dtype=np.complex128)
        data[0, : N - m] = np.diagonal(A, -m)
        data[1, m:] = np.diagonal(A, m)
        return dia_matrix((data, np.array([-m, m])), shape=(N, N))

    Pexact, Wexact = get_random_poisson_solution(N=N, seed=N)
    Wm = _t(tl.laplace, extract_dia(Pexact))
    assert isinstance(Wm, dia_matrix)
    np.testing.assert_allclose(Wm.toarray(), extract_dia(Wexact).toarray(),
                               atol=1e-10)
    np.testing.assert_allclose(
        Wm.toarray(), jl.laplace(extract_dia(Pexact)).toarray(), atol=1e-10)
    Pm = _t(tl.solve_poisson, extract_dia(Wexact))
    np.testing.assert_allclose(Pm.toarray(), extract_dia(Pexact).toarray(),
                               atol=1e-12 * N)
    assert _rel(Pm.toarray(),
                jl.solve_poisson(extract_dia(Wexact)).toarray()) <= 1e-13


@pytest.mark.parametrize("el,m", [(5, 0), (5, 3), (9, -4)])
def test_el_fast_path(el, m):
    N = 19
    T = qt.quantization.elmr2mat(el, m, N)
    W = _t(tl.laplace, T)
    np.testing.assert_allclose(W.toarray(), -el * (el + 1) * T.toarray(),
                               atol=1e-12)
    assert W.el == el
    P = _t(tl.solve_poisson, W)
    np.testing.assert_allclose(P.toarray(), T.toarray(), atol=1e-12)
    assert P.el == el


# ---------------------------------------------------------------------------
# devices, the column solve, the factor cache, complex64
# ---------------------------------------------------------------------------

def test_devices(monkeypatch):
    """A tensor stays a tensor on its device, numpy comes back as numpy;
    without a card the default device raises."""
    W = get_random_mat(12, seed=1)
    Wt = torch.from_numpy(W)
    for family in sorted(FAMILIES):
        out_t = FAMILIES[family](tl, Wt, skewh=True)
        out_n = FAMILIES[family](tl, W, skewh=True, device="cpu")
        assert isinstance(out_t, torch.Tensor) and out_t.device == Wt.device
        assert isinstance(out_n, np.ndarray)
        np.testing.assert_array_equal(out_t.numpy(), out_n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for family in sorted(FAMILIES):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FAMILIES[family](tl, W, skewh=True)


@pytest.mark.parametrize("kernel", ["thomas", "scan"])
def test_every_solve_goes_through_the_selected_column_solve(monkeypatch,
                                                            kernel):
    """One call of the column solve per family solve, the one
    QUFLOW_PALLAS_KERNEL selects; laplace calls none; an explicit
    ``solver`` wins and gives the same bits as the default on the CPU."""
    calls = []

    def counted(name, fn):
        def solve(w, binv, u, d):
            calls.append(name)
            return fn(w, binv, u, d)
        return solve

    monkeypatch.setattr(shear_solve, "shear_thomas",
                        counted("thomas", shear_thomas_reference))
    monkeypatch.setattr(shear_solve, "shear_scan",
                        counted("scan", shear_scan_reference))
    monkeypatch.setenv("QUFLOW_PALLAS_KERNEL", kernel)
    W = get_random_mat(10, seed=2)
    plain = {"thomas": shear_thomas_reference,
             "scan": shear_scan_reference}[kernel]
    for family in sorted(FAMILIES):
        calls.clear()
        got = FAMILIES[family](tl, W, skewh=True, device="cpu")
        assert calls == ([] if family == "laplace" else [kernel])
        if family != "laplace":
            np.testing.assert_array_equal(
                FAMILIES[family](tl, W, skewh=True, device="cpu",
                                 solver=plain), got)


def test_factor_caches():
    """256 host operator sets, as quflow_tpu keeps; the device copies are
    made once per (N, family, dtype, device)."""
    assert shear_solve._shear_factors_cached.cache_info().maxsize == 256
    dev = torch.device("cpu")
    a = shear_solve.device_factors(20, "heat", (0.5,), np.dtype(np.float32),
                                   dev)
    b = shear_solve.device_factors(20, "heat", (0.5,), np.dtype(np.float32),
                                   dev)
    assert all(x is y for x, y in zip(a, b))
    assert a[0].dtype == torch.float32 and a[0].shape == (20, 21)
    w, binv, u, _ = shear_solve._shear_factors_cached(20, "heat", (0.5,))
    np.testing.assert_array_equal(a[1].numpy(), binv.astype(np.float32))


@pytest.mark.parametrize("family", sorted(set(FAMILIES) - {"laplace",
                                                           "viscdamp_cn"}))
@pytest.mark.parametrize("N", [64, 65])
def test_complex64_error_comparable(family, N):
    """In complex64 each family's error against the complex128 solve stays
    within 3x that of quflow_tpu's own complex64 solve (the rule of
    tests/test_torch_scan.py).  (quflow_tpu's laplace, and with it
    solve_viscdamp at theta != 1, promotes complex64 to complex128; the
    port keeps complex64: tested below.)"""
    W = get_random_mat(N, seed=N)
    W64 = W.astype(np.complex64)
    truth = FAMILIES[family](tl, W, skewh=True, device="cpu")
    got = FAMILIES[family](tl, W64, skewh=True, device="cpu")
    ref = np.asarray(FAMILIES[family](jl, W64, skewh=True))
    assert got.dtype == np.complex64 and ref.dtype == np.complex64
    assert _rel(got, truth) < 3 * _rel(ref, truth)


@pytest.mark.parametrize("family", ["laplace", "viscdamp_cn"])
def test_complex64_stays_complex64(family):
    """The port's laplace keeps the input's dtype: float32 rounding of the
    complex128 result."""
    W = get_random_mat(33, seed=4)
    got = FAMILIES[family](tl, W.astype(np.complex64), skewh=True,
                           device="cpu")
    truth = FAMILIES[family](tl, W, skewh=True, device="cpu")
    assert got.dtype == np.complex64
    assert _rel(got, truth) <= 1e-5


# ---------------------------------------------------------------------------
# the operators and the compatibility package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [8, 9, 17, 32])
@pytest.mark.parametrize("bc", [False, True])
def test_host_operators_bit_equal(N, bc):
    for nrows in (N // 2 + 1, N):
        np.testing.assert_array_equal(
            tridiag.packed_laplacian(N, nrows=nrows, bc=bc),
            qf.ops.tridiag.packed_laplacian(N, nrows=nrows, bc=bc))
    np.testing.assert_array_equal(
        tlap.tridiagonal.compute_tridiagonal_laplacian(N, bc=bc),
        jlap.tridiagonal.compute_tridiagonal_laplacian(N, bc=bc))
    np.testing.assert_array_equal(
        tlap.direct.compute_direct_laplacian(N, bc=bc),
        jlap.direct.compute_direct_laplacian(N, bc=bc))
    for skewh in (True, False):
        np.testing.assert_array_equal(tl.laplacian(N, bc=bc, skewh=skewh),
                                      jl.laplacian(N, bc=bc, skewh=skewh))
        for a, b in zip(diagpack.pack_indices(N, skewh),
                        qf.ops.diagpack.pack_indices(N, skewh)):
            np.testing.assert_array_equal(a, b)


OPERATORS = [("poisson", ()), ("heat", (0.001,)), ("helmholtz", (0.1,)),
             ("viscdamp", (0.1, 0.01, 0.6, 1.0)),
             ("viscdamp", (0.1, 0.01, 0.6, 0.5)), ("globalqg", (0.7,))]


@pytest.mark.parametrize("kind,params", OPERATORS)
@pytest.mark.parametrize("N", [8, 9, 32, 33])
def test_shear_operator_equals_row_packed_per_diagonal(N, kind, params):
    """For every family and every diagonal, the shear operator's
    coefficients (read through _shear_slots) equal those of quflow_tpu's
    row-packed operator (ops/laplacian._factors(...).op, read through
    pack_indices) to the last bit: the main coefficient of each matrix
    entry and the coupling to the next entry along its diagonal."""
    def dense(op, rows, cols, valid):
        main = np.full((N, N), np.nan)
        coup = np.full((N, N), np.nan)
        main[rows[valid], cols[valid]] = op[:, 0, :][valid]
        coup[rows[valid], cols[valid]] = op[:, 1, :][valid]
        return main, coup

    rr, cc, valid = tridiag._shear_slots(N)
    shear = dense(tridiag.shear_operator(N, kind, params), rr, cc, valid)
    assert not np.isnan(shear[0]).any()
    for skewh in (True, False):
        rows, cols = qf.ops.diagpack.pack_indices(N, skewh)
        packed = dense(jl._factors(N, skewh, kind, params).op, rows, cols,
                       np.ones(rows.shape, bool))
        held = ~np.isnan(packed[0])
        assert held.sum() == (N * (N + 1) // 2 if skewh else N * N)
        for s, p in zip(shear, packed):
            np.testing.assert_array_equal(s[held], p[held])
            if skewh:  # the upper diagonals carry the same coefficients
                np.testing.assert_array_equal(s.T[held], p[held])


@pytest.mark.parametrize("N", [16, 17])
@pytest.mark.parametrize("tracefree", [True, False])
def test_solve_tridiagonal_matches_unified_backend(N, tracefree):
    W = get_random_mat(N, zero_trace=tracefree, seed=1)
    lap = tlap.tridiagonal.compute_tridiagonal_laplacian(N, bc=True)
    P_compat = tlap.tridiagonal.solve_tridiagonal(lap, W)
    np.testing.assert_allclose(P_compat, _t(tlap.solve_poisson, W),
                               atol=1e-12)
    np.testing.assert_allclose(P_compat,
                               jlap.tridiagonal.solve_tridiagonal(lap, W),
                               atol=1e-14)


def test_dot_tridiagonal_inverts_solve_and_subtracts_trace():
    N = 16
    W = get_random_mat(N, seed=2)
    lap_bc = tlap.tridiagonal.compute_tridiagonal_laplacian(N, bc=True)
    lap = tlap.tridiagonal.compute_tridiagonal_laplacian(N, bc=False)
    P = tlap.tridiagonal.solve_tridiagonal(lap_bc, W)
    np.testing.assert_allclose(tlap.tridiagonal.dot_tridiagonal(lap, P), W,
                               atol=1e-12)
    shifted = P + (0.7j / N) * np.eye(N)  # skew-Hermitian, trace 0.7j
    np.testing.assert_allclose(tlap.tridiagonal.dot_tridiagonal(lap, shifted),
                               tlap.tridiagonal.dot_tridiagonal(lap, P),
                               atol=1e-12)


@pytest.mark.parametrize("skewh", [True, False])
@pytest.mark.parametrize("N", [12, 13])
def test_row_format_matches_quflow_tpu(N, skewh):
    """mat2diagh/diagh2mat and dot_packed, numpy and tensors, against
    quflow_tpu's; the compatibility module's round trip."""
    W = get_random_mat(N, seed=3, skewh=skewh)
    for tracefree in (True, False):
        ref = np.asarray(qf.ops.diagpack.mat2diagh(W, skewh=skewh,
                                                   tracefree=tracefree))
        got = diagpack.mat2diagh(W, skewh=skewh, tracefree=tracefree)
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
        got_t = diagpack.mat2diagh(torch.from_numpy(W), skewh=skewh,
                                   tracefree=tracefree)
        # the trace sums in another order in torch than in numpy
        np.testing.assert_allclose(got_t.numpy(), got, rtol=0, atol=1e-15)
    d = diagpack.mat2diagh(W, skewh=skewh, tracefree=False)
    op = tl.laplacian(N, skewh=skewh)
    np.testing.assert_array_equal(
        tridiag.dot_packed(op, d),
        np.asarray(qf.ops.tridiag.dot_packed(jnp.asarray(op),
                                             jnp.asarray(d))))
    back = diagpack.diagh2mat(d, skewh=skewh)
    np.testing.assert_array_equal(
        back, np.asarray(qf.ops.diagpack.diagh2mat(d, skewh=skewh)))
    np.testing.assert_array_equal(
        diagpack.diagh2mat(torch.from_numpy(d), skewh=skewh).numpy(), back)
    np.testing.assert_allclose(back, W, atol=1e-15)
    if skewh:
        dt = tlap.tridiagonal.mat2diagh(W)
        assert isinstance(dt, np.ndarray) and dt.shape == (N // 2 + 1, N)
        np.testing.assert_allclose(tlap.tridiagonal.diagh2mat(dt),
                                   W - np.eye(N) * np.trace(W) / N,
                                   atol=1e-14)


def test_backend_aliases_all_resolve_to_unified():
    W = get_random_mat(8, seed=4)
    ref = _t(tlap.solve_poisson, W)
    for backend in (tlap.cpu, tlap.direct, tlap.sparse, tlap.gpu,
                    tlap.tridiagonal):
        np.testing.assert_array_equal(_t(backend.solve_poisson, W), ref)
        assert backend.solve_heat is tl.solve_heat
    for backend in (tlap.cpu, tlap.direct, tlap.sparse, tlap.gpu):
        assert backend.laplacian is tl.laplacian
    assert qt.laplacian is tlap and qt.solve_poisson is tl.solve_poisson
    assert qt.compute_direct_laplacian is tlap.direct.compute_direct_laplacian


def test_mk2ij_ij2mk_roundtrip():
    for m in range(-5, 6):
        for k in range(4):
            i, j = tlap.cpu.mk2ij(m, k)
            assert (i, j) == jlap.cpu.mk2ij(m, k)
            assert tlap.cpu.ij2mk(i, j) == (m, k)


def test_select_skewherm_default(monkeypatch):
    """The reference's module switch sets the default skewh."""
    monkeypatch.setattr(tl, "_skewh_default", None)
    W = get_random_mat(9, skewh=False, seed=5)
    assert tl.select_skewherm(True) is True
    np.testing.assert_array_equal(_t(tl.solve_poisson, W),
                                  _t(tl.solve_poisson, W, skewh=True))
    assert tl.select_skewherm(False) is True
    np.testing.assert_array_equal(_t(tl.solve_poisson, W),
                                  _t(tl.solve_poisson, W, skewh=False))


@pytest.mark.cuda
def test_families_on_card_launch_the_kernel(cuda):
    """On the card each family solve launches the selected kernel once and
    gives the bits of its plain version; laplace launches none."""
    from quflow_tpu_torch.ops.cuda_scan_solve import shear_scan
    from quflow_tpu_torch.ops.cuda_solve import shear_thomas

    W = get_random_mat(257, seed=7)
    for dtype in (torch.complex128, torch.complex64):
        Wt = torch.from_numpy(W).to(cuda, dtype)
        for family in sorted(FAMILIES):
            before = (shear_thomas.launches, shear_scan.launches)
            got = FAMILIES[family](tl, Wt, skewh=True)
            n = 0 if family == "laplace" else 1
            assert (shear_thomas.launches, shear_scan.launches) == (
                before[0] + n, before[1])
            if n:
                plain = FAMILIES[family](tl, Wt, skewh=True,
                                         solver=shear_thomas_reference)
                assert torch.equal(got, plain)
