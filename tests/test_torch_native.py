"""quflow_tpu_torch.native against quflow_tpu.native (twins of
tests/test_native.py) on the same numpy-seeded inputs.  The port builds
native/quflow_host.cpp into quflow_tpu_torch/_build/ and leaves
native/libquflow_host.so as it is."""

import hashlib
from pathlib import Path

import numpy as np
import pytest

import quflow_tpu as qf
from quflow_tpu import native as jnative

from quflow_tpu_torch import native
from quflow_tpu_torch.ops.diagpack import mat2diagh
from quflow_tpu_torch.ops.tridiag import TridiagFactors, packed_laplacian

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "native" / "libquflow_host.so"


@pytest.fixture(scope="module")
def lib():
    """The port's library, built here; the committed native/ library's
    digest read before and after the build."""
    before = hashlib.sha256(COMMITTED.read_bytes()).hexdigest()
    if not native.available():
        pytest.skip("no C++ toolchain to build native/quflow_host.cpp")
    yield native
    assert hashlib.sha256(COMMITTED.read_bytes()).hexdigest() == before


def rsk(N, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    return W - W.conj().T


def test_builds_into_build_dir(lib):
    path = native._LIBRARY.library_path()
    assert path.exists() and path.parent == ROOT / "quflow_tpu_torch" / "_build"
    assert (ROOT / "native" / "quflow_host.cpp") == native.SOURCE


@pytest.mark.parametrize("N", [9, 33, 128])
def test_native_solve_poisson_equivalence(lib, N):
    """Within 1e-13 N of quflow_tpu's native solve and of the port's
    solve_poisson (tests/test_native.py's tolerance)."""
    W = rsk(N, seed=N)
    P = lib.solve_poisson_native(W)
    np.testing.assert_allclose(P, jnative.solve_poisson_native(W),
                               atol=1e-13 * N)
    import quflow_tpu_torch as qt

    np.testing.assert_allclose(P, qt.solve_poisson(W, skewh=True,
                                                   device="cpu"),
                               atol=1e-13 * N)


def test_native_conj_subtract(lib):
    rng = np.random.RandomState(1)
    A = rng.randn(16, 16) + 1j * rng.randn(16, 16)
    out = lib.conj_subtract_native(A.copy())
    np.testing.assert_allclose(out, A - A.conj().T, atol=1e-14)
    np.testing.assert_array_equal(out, jnative.conj_subtract_native(A.copy()))


def test_native_thomas_batch(lib):
    """The packed-row solve against quflow_tpu's native one within 1e-12
    (native/Makefile builds with -march=native, the port without, so
    fused multiply-adds may round apart) and against its factors' plain
    solve, within 1e-11."""
    from quflow_tpu.ops.laplacian import _factors

    N = 32
    fac = TridiagFactors(packed_laplacian(N, nrows=N // 2 + 1, bc=True))
    jfac = _factors(N, True, "poisson", ())
    for a, b in ((fac.w, jfac.w), (fac.binv, jfac.binv), (fac.u, jfac.u)):
        np.testing.assert_array_equal(a, b)
    W = rsk(N, seed=2)
    d = mat2diagh(W, skewh=True, tracefree=True)
    stacked = np.stack([d.real, d.imag])
    out = lib.thomas_batch(fac.w, fac.binv, fac.u, stacked.copy())
    ref = jnative.thomas_batch(jfac.w, jfac.binv, jfac.u, stacked.copy())
    np.testing.assert_allclose(out, ref, atol=1e-12)
    from quflow_tpu.ops.tridiag import solve_factored

    np.testing.assert_allclose(out[0] + 1j * out[1],
                               np.asarray(solve_factored(jfac, d)), atol=1e-11)


def test_native_checks_inputs(lib):
    with pytest.raises(ValueError, match="square"):
        lib.solve_poisson_native(np.zeros((4, 5), complex))
    with pytest.raises(ValueError, match="expected"):
        lib.thomas_batch(np.zeros((3, 8)), np.zeros((3, 8)), np.zeros((2, 8)),
                         np.zeros((2, 3, 8)))


def test_builds_without_openmp(monkeypatch, tmp_path):
    """A compiler that refuses -fopenmp (no libgomp, as on the card's
    host) builds the same kernels serially: one thread, and the same
    solve as the OpenMP build's."""
    real = native.shutil.which("g++")
    if real is None:
        pytest.skip("no g++")
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\n"
                    'case "$*" in *-fopenmp*) echo "no libgomp.spec" >&2; '
                    "exit 1;; esac\n"
                    f'exec {real} "$@"\n')
    fake.chmod(0o755)
    W = rsk(24, seed=5)
    P = native.solve_poisson_native(W) if native.available() else None
    lib = native._HostLibrary()
    monkeypatch.setattr(native, "_LIBRARY", lib)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(fake))
    assert native.available() and native.threads() == 1
    assert lib.library_path(native.FLAG_SETS[1]).exists()
    assert not lib.library_path(native.FLAG_SETS[0]).exists()
    if P is not None:
        np.testing.assert_allclose(native.solve_poisson_native(W), P,
                                   atol=1e-13 * 24)


def test_missing_library_raises(monkeypatch, tmp_path):
    """No compiler: available() says so and the entry points raise; they
    never compute another way."""
    lib = native._HostLibrary()
    monkeypatch.setattr(native, "_LIBRARY", lib)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.available() is False
    for call in (lambda: native.solve_poisson_native(rsk(8)),
                 lambda: native.conj_subtract_native(rsk(8)),
                 lambda: native.thomas_batch(*(np.zeros((1, 4)),) * 3,
                                             np.zeros((1, 1, 4)))):
        with pytest.raises(RuntimeError, match="native library unavailable"):
            call()
