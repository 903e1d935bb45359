"""quflow_tpu_torch.io against quflow_tpu.io: basis files (HDF5, npy, npz,
mat), states and the QuData callback written by either package load in
the other; the basis disk cache of quantization.get_basis; the
classification of state data.  File contents are compared exactly (the
formats are the same bytes, not a tolerance)."""

import os

import numpy as np
import pytest

import quflow_tpu as qf
from quflow_tpu import io as jio

import quflow_tpu_torch as qt
from quflow_tpu_torch import io as tio
from quflow_tpu_torch.quantization import basis as tbasis

h5py = pytest.importorskip("h5py")

PACKAGES = {"jax": jio, "torch": tio}
PAIRS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]


@pytest.fixture
def basis_env(tmp_path, monkeypatch):
    monkeypatch.setenv("QUFLOW_BASIS_PATH", str(tmp_path))
    monkeypatch.setenv("QUFLOW_BASIS_FILENAME", "testbasis.hdf5")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return tmp_path


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_basis_hdf5_interchanges(basis_env, writer, reader):
    basis = qf.compute_basis(9)
    path = PACKAGES[writer].save_basis(
        basis, path=str(basis_env / "testbasis.hdf5"))
    assert os.path.exists(path)
    np.testing.assert_array_equal(PACKAGES[reader].load_basis(9), basis)
    assert PACKAGES[reader].load_basis(33) is None  # other N not present
    np.testing.assert_array_equal(
        PACKAGES[reader].load_basis_hdf5(path, 9), basis)
    with h5py.File(path, "r") as f:
        assert list(f) == ["BASIS_9"]


@pytest.mark.parametrize("fmt", ["npy", "npz", "mat"])
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_basis_npy_npz_mat_load_alike(basis_env, monkeypatch, fmt, package):
    """A basis file in each of the other formats, written once, loads the
    same in both packages through the search path and the per-format
    loaders."""
    from scipy.io import savemat

    basis = qt.compute_basis(7)
    name = f"b.{fmt}"
    path = str(basis_env / name)
    if fmt == "npy":
        np.save(path, basis)
    elif fmt == "npz":
        np.savez(path, BASIS_7=basis)
    else:
        savemat(path, {"BASIS_7": basis})
    monkeypatch.setenv("QUFLOW_BASIS_FILENAME", name)
    got = PACKAGES[package].load_basis(7)
    np.testing.assert_array_equal(got, jio.load_basis(7))
    np.testing.assert_array_equal(got, basis)
    if fmt == "npy":
        np.testing.assert_array_equal(tio.load_basis_npy(path, 7), basis)
        assert tio.load_basis_npy(path, 8) is None
    if fmt == "mat":
        np.testing.assert_array_equal(tio.load_basis_mat(path, 7), basis)
        out = PACKAGES[package].convert_mat_to_hdf5_basis(path)
        other = tio if package == "jax" else jio
        np.testing.assert_array_equal(other.load_basis_hdf5(out, 7), basis)


@pytest.mark.parametrize("N", [1, 3, 9, 17, 64])
def test_get_N_for_basis(N):
    ln = N * (N + 1) * (2 * N + 1) // 6
    assert tio.get_N_for_basis(ln) == jio.get_N_for_basis(ln) == N


def test_get_N_for_basis_rejects():
    with pytest.raises(ValueError):
        tio.get_N_for_basis(12345)


def test_basis_dirs_and_files(basis_env):
    assert tio.get_basis_dirs() == jio.get_basis_dirs()
    assert tio.get_basis_dirs()[0] == str(basis_env)
    assert tio.get_basis_files() == jio.get_basis_files() == []
    tio.save_basis(qt.compute_basis(4))  # the first writable: the last dir
    assert tio.get_basis_files() == jio.get_basis_files()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_state_interchanges(tmp_path, writer, reader):
    f = str(tmp_path / "state.hdf5")
    omega = np.random.RandomState(0).randn(25)
    PACKAGES[writer].save(f, omega, qtype="shr", attrs={"N": 5})
    np.testing.assert_array_equal(PACKAGES[reader].load(f), omega)
    with h5py.File(f, "r") as h:
        assert h["state"].attrs["qtype"] == "shr"
        assert h["state"].attrs["N"] == 5


def test_qudata_writes_what_quflow_tpu_writes(tmp_path):
    W = qf.shr2mat(np.random.RandomState(1).randn(49), N=7)
    files = {}
    for key, mod in PACKAGES.items():
        files[key] = str(tmp_path / f"qudata_{key}.hdf5")
        qd = mod.QuData(files[key], cache_size=3, qtype="shr")
        for _ in range(5):
            qd(W, inner_time=0.5)
        qd.flush()
    with h5py.File(files["jax"], "r") as hj, \
            h5py.File(files["torch"], "r") as ht:
        assert ht["state"].shape == hj["state"].shape == (5, 49)
        np.testing.assert_array_equal(ht["qtime"][:], hj["qtime"][:])
        np.testing.assert_array_equal(ht["qtime"][:], 0.5 * np.arange(1, 6))
        np.testing.assert_allclose(ht["state"][:], hj["state"][:],
                                   rtol=0, atol=1e-13)


_QTYPE_CASES = {
    "mat_seq": (np.zeros((3, 4, 4), complex), None),
    "img_seq": (np.zeros((3, 4, 4), np.uint8), None),
    "fun_seq": (np.zeros((3, 4, 4)), None),
    "shc": (np.zeros(16, complex), None),
    "shr": (np.zeros(16), None),
    "img": (np.zeros((4, 4), np.uint8), None),
    "mat": (np.zeros((4, 4), complex), 4),
    "shr_seq": (np.zeros((3, 16)), 4),
    "shc_seq": (np.zeros((3, 16), complex), 4),
    "fun": (np.zeros((4, 7)), 4),
    "unknown": (np.zeros((4, 4)), None),
}


@pytest.mark.parametrize("case", sorted(_QTYPE_CASES))
def test_determine_qtype_matches(case):
    data, N = _QTYPE_CASES[case]
    assert tio.determine_qtype(data, N=N) == jio.determine_qtype(data, N=N)


def test_get_basis_disk_cache(basis_env, monkeypatch):
    """get_basis: memory, then disk (a file quflow_tpu wrote), then
    compute; QUFLOW_SAVE_COMPUTED_BASIS writes a computed basis back."""
    monkeypatch.setattr(tbasis, "_basis_cache", {})
    marked = 2.0 * qf.compute_basis(6)  # not what compute_basis gives
    jio.save_basis(marked, path=str(basis_env / "testbasis.hdf5"))
    np.testing.assert_array_equal(qt.get_basis(6), marked)
    assert qt.get_basis(6) is qt.get_basis(6)  # then from memory
    # not on disk and not computed
    assert qt.get_basis(5, allow_compute=False) is None
    monkeypatch.setenv("QUFLOW_SAVE_COMPUTED_BASIS", "1")
    computed = qt.get_basis(5)
    np.testing.assert_array_equal(computed, qf.compute_basis(5))
    np.testing.assert_array_equal(jio.load_basis(5), computed)
    monkeypatch.setenv("QUFLOW_SAVE_COMPUTED_BASIS", "0")
    qt.get_basis(4)
    assert jio.load_basis(4) is None
