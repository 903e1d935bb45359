"""File I/O: basis persistence, generic save/load, QuData legacy callback.

Functional parity with reference quflow/io.py (basis search path :98-136,
HDF5/npy/npz/mat formats :34-95 and :506-548, ``QuData`` :211-329,
``save``/``load`` :332-471).  The basis file format is compatible with the
reference ('BASIS_<N>' HDF5 datasets), so precomputed bases interchange.

A copy of quflow_tpu/io.py: the files either package writes load in the
other.  h5py is imported at first use, so that the package imports on a
host without it.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "load_basis",
    "save_basis",
    "get_basis_dirs",
    "get_basis_files",
    "get_N_for_basis",
    "load_basis_hdf5",
    "load_basis_npy",
    "load_basis_mat",
    "save_basis_hdf5",
    "convert_mat_to_hdf5_basis",
    "determine_qtype",
    "QuData",
    "save",
    "load",
]

_DEFAULT_BASIS_FILENAME = "quflow_basis.hdf5"


def get_N_for_basis(basis_len):
    """Invert N from len = sum_{m<N} (N-m)^2 = N(N+1)(2N+1)/6."""
    N = int(round((3.0 * basis_len) ** (1.0 / 3.0)))
    for cand in (N - 1, N, N + 1):
        if cand > 0 and cand * (cand + 1) * (2 * cand + 1) // 6 == basis_len:
            return cand
    raise ValueError(f"No N found for basis length {basis_len}.")


def get_basis_dirs():
    """Search directories: $QUFLOW_BASIS_PATH (colon list) then a per-user
    data dir (~/.local/share/quflow, replacing the reference's appdirs)."""
    dirs = []
    env = os.environ.get("QUFLOW_BASIS_PATH", "")
    for d in env.split(":"):
        if d:
            dirs.append(d)
    home = os.path.expanduser("~")
    dirs.append(os.path.join(home, ".local", "share", "quflow"))
    return dirs


def get_basis_files(basis_filename=None):
    files = []
    names = (
        [basis_filename]
        if basis_filename
        else [os.environ.get("QUFLOW_BASIS_FILENAME", _DEFAULT_BASIS_FILENAME)]
    )
    for d in get_basis_dirs():
        for nm in names:
            f = os.path.join(d, nm)
            if os.path.isfile(f):
                files.append(f)
    return files


def _load_basis_hdf5(path, N):
    import h5py

    with h5py.File(path, "r") as f:
        key = f"BASIS_{N}"
        if key in f:
            return f[key][()]
    return None


def _load_basis_npy(path, N):
    basis = np.load(path, allow_pickle=False)
    if isinstance(basis, np.lib.npyio.NpzFile):
        key = f"BASIS_{N}"
        basis = basis[key] if key in basis else None
    if basis is not None and get_N_for_basis(basis.shape[0]) != N:
        return None
    return basis


def load_basis(N):
    """Look for a precomputed basis for band limit N on disk."""
    for path in get_basis_files():
        try:
            if path.endswith((".hdf5", ".h5")):
                basis = _load_basis_hdf5(path, N)
            elif path.endswith((".npy", ".npz")):
                basis = _load_basis_npy(path, N)
            elif path.endswith(".mat"):
                from scipy.io import loadmat

                data = loadmat(path)
                basis = data.get(f"BASIS_{N}", None)
                if basis is not None:
                    basis = basis.ravel()
            else:
                continue
        except (OSError, ValueError):
            continue
        if basis is not None:
            return np.ascontiguousarray(basis)
    return None


def load_basis_hdf5(path, N):
    """Public per-format loader (reference io.py:61-70 parity)."""
    return _load_basis_hdf5(path, N)


def load_basis_npy(path, N=None):
    """Public per-format loader (reference io.py:72-74 parity)."""
    basis = np.load(path, allow_pickle=False)
    if N is not None and get_N_for_basis(basis.shape[0]) != N:
        return None
    return basis


def load_basis_mat(path, N=None):
    """Load a basis from a MATLAB .mat file (reference io.py:34-58 parity):
    the file holds a single flat basis vector (any variable name)."""
    from scipy.io import loadmat

    data = loadmat(path)
    for key, val in data.items():
        if key.startswith("__"):
            continue
        basis = np.asarray(val).ravel()
        if N is None or get_N_for_basis(basis.shape[0]) == N:
            return np.ascontiguousarray(basis)
    return None


def save_basis_hdf5(path, basis):
    """Append ``basis`` as BASIS_<N> to an HDF5 file (reference io.py:84-95
    parity).  Returns True on success."""
    import h5py

    N = get_N_for_basis(basis.shape[0])
    with h5py.File(path, "a") as f:
        key = f"BASIS_{N}"
        if key in f:
            del f[key]
        ds = f.create_dataset(key, data=np.asarray(basis))
        ds.attrs["QUFLOW_VERSION"] = "quflow_tpu_torch"
    return True


def convert_mat_to_hdf5_basis(matpath, hdf5path=None):
    """Convert a MATLAB basis file to the HDF5 basis format (reference
    io.py:139-143 parity)."""
    basis = load_basis_mat(matpath)
    if basis is None:
        raise ValueError(f"No basis found in {matpath}.")
    if hdf5path is None:
        hdf5path = os.path.splitext(matpath)[0] + ".hdf5"
    save_basis_hdf5(hdf5path, basis)
    return hdf5path


def determine_qtype(data, N=None):
    """Classify state data: returns ``(qtype, issequence)`` with qtype in
    {'mat','shr','shc','fun','img'} or None (reference io.py:146-204 parity).

    Dispatch: 3-d arrays are sequences (complex -> mat, uint8 -> img, else
    fun); 1-d arrays are single coefficient vectors (complex -> shc, else
    shr); 2-d uint8 is a single img; other 2-d shapes need ``N`` to
    disambiguate a single (N, N) mat / grid fun from a sequence of length-N^2
    coefficient rows.
    """
    data = np.asarray(data)
    if data.ndim == 3:
        if np.iscomplexobj(data):
            return "mat", True
        if data.dtype == np.dtype("uint8"):
            return "img", True
        return "fun", True
    if data.ndim == 1:
        return ("shc" if np.iscomplexobj(data) else "shr"), False
    if data.ndim == 2:
        if data.dtype == np.dtype("uint8"):
            return "img", False
        if N is not None:
            if data.shape == (N, N) and np.iscomplexobj(data):
                return "mat", False
            if data.shape[-1] == N ** 2:
                return ("shr" if np.isrealobj(data) else "shc"), True
            if np.isrealobj(data):
                return "fun", False
    return None, None


def save_basis(basis, path=None):
    """Append the basis to the (first writable) basis file as BASIS_<N>."""
    import h5py

    N = get_N_for_basis(basis.shape[0])
    if path is None:
        d = get_basis_dirs()[-1]
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, os.environ.get("QUFLOW_BASIS_FILENAME", _DEFAULT_BASIS_FILENAME)
        )
    with h5py.File(path, "a") as f:
        key = f"BASIS_{N}"
        if key in f:
            del f[key]
        ds = f.create_dataset(key, data=basis)
        ds.attrs["QUFLOW_VERSION"] = "quflow_tpu_torch"
    return path


# ---------------------------------------------------------------------------
# generic state save/load + legacy QuData callback
# ---------------------------------------------------------------------------

def save(filename, data, qtype="shr", name="state", attrs=None):
    """Save a state (in representation ``qtype``) to an HDF5 file."""
    import h5py

    with h5py.File(filename, "a") as f:
        if name in f:
            del f[name]
        ds = f.create_dataset(name, data=np.asarray(data))
        ds.attrs["qtype"] = qtype
        for k, v in (attrs or {}).items():
            ds.attrs[k] = v


def load(filename, name="state"):
    import h5py

    with h5py.File(filename, "r") as f:
        return f[name][()]


class QuData:
    """Legacy buffered HDF5 writer callback (reference io.py:211-329).

    Caches up to ``cache_size`` states in memory and flushes at least every
    ``max_wait`` seconds.  The modern interface is sim.QuSimulation.
    """

    def __init__(self, filename, cache_size=20, max_wait=60.0, qtype="shr", verbatim=False):
        self.filename = filename
        self.cache_size = cache_size
        self.max_wait = max_wait
        self.qtype = qtype
        self.verbatim = verbatim
        self._cache = []
        self._times = []
        import time as _time

        self._last_flush = _time.time()
        self.qtime = 0.0

    def __call__(self, W, inner_time=None, inner_steps=None, delta_time=None,
                 **kwargs):
        from .quantization import mat2shr

        if inner_time is None and delta_time is not None:
            inner_time = delta_time  # the callback signature of sim.solve
        if inner_time is not None:
            self.qtime += float(inner_time)
        data = mat2shr(np.asarray(W)) if self.qtype == "shr" else np.asarray(W)
        self._cache.append(data)
        self._times.append(self.qtime)
        import time as _time

        now = _time.time()
        if len(self._cache) >= self.cache_size or now - self._last_flush > self.max_wait:
            self.flush()

    def flush(self):
        if not self._cache:
            return
        import h5py
        import time as _time

        with h5py.File(self.filename, "a") as f:
            block = np.stack(self._cache)
            times = np.asarray(self._times)
            if "state" not in f:
                f.create_dataset(
                    "state",
                    data=block,
                    maxshape=(None,) + block.shape[1:],
                    chunks=True,
                )
                f.create_dataset("qtime", data=times, maxshape=(None,), chunks=True)
            else:
                ds = f["state"]
                n0 = ds.shape[0]
                ds.resize(n0 + block.shape[0], axis=0)
                ds[n0:] = block
                dt_ = f["qtime"]
                dt_.resize(n0 + times.shape[0], axis=0)
                dt_[n0:] = times
        self._cache = []
        self._times = []
        self._last_flush = _time.time()

    def __del__(self):
        try:
            self.flush()
        except Exception:
            pass
