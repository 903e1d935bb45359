"""Function-space conversions: fun <-> SH coefficients <-> matrices <-> images.

Functional parity with reference quflow/transforms.py:189-530 (``fun2shc``,
``shc2fun``, ``shc2shr``, ``shr2shc``, ``fun2img``, ``img2fun``, ``fun2shr``,
``shr2fun``, dispatchers ``as_fun``/``as_shr``), on the native Gauss-Legendre
SHT of quflow_tpu/ops/sht.py instead of ducc0 (see that module's docstring).

Grid interop: every fun-facing function takes ``grid='gl'`` (native,
exact-quadrature) or ``grid='mw'`` (the reference's McEwen-Wiaux sampling) -
so ``fun`` datasets written by the reference read, analyze, and round-trip
here, and vice versa.  ``forward``/``inverse`` provide the pyssht-style API
the reference emulates over ducc0 (reference quflow/transforms.py:117-183).
"""

from __future__ import annotations

import numpy as np

from .utils import elm2ind, ind2elm, complex_dtype, real_dtype, berezin_multipliers
from .ops.sht import (
    shsynthesis,
    shanalysis,
    shsynthesis_mw,
    shanalysis_mw,
)
from .quantization import mat2shr, mat2shc

__all__ = [
    "fun2shc",
    "shc2fun",
    "fun2shr",
    "shr2fun",
    "shc2shr",
    "shr2shc",
    "fun2img",
    "img2fun",
    "as_fun",
    "as_shr",
    "forward",
    "inverse",
    "mw2gl",
    "gl2mw",
]


def _grid_fns(grid):
    if grid in ("gl", "GL"):
        return shanalysis, shsynthesis
    if grid in ("mw", "MW"):
        return shanalysis_mw, shsynthesis_mw
    raise ValueError(f"unknown grid {grid!r}; use 'gl' or 'mw'")


def fun2shc(f, grid="gl"):
    """Grid function (N, 2N-1) -> complex SH coefficients (length N^2),
    scaled by 1/sqrt(4 pi) as in the reference.  ``grid`` selects the
    sampling the input lives on ('gl' native, 'mw' = reference files)."""
    f = np.ascontiguousarray(f)
    N = f.shape[0]
    assert 2 * N - 1 == f.shape[1], "Shape of input must be (N, 2*N-1)."
    analysis, _ = _grid_fns(grid)
    reality = np.isrealobj(f)
    if reality:
        omega = analysis(f.astype(np.float64), N, reality=True)
    else:
        omega = analysis(f.astype(np.complex128), N, reality=False)
    return omega / np.sqrt(4.0 * np.pi)


def shc2fun(omega, isreal=False, N=-1, berezin=True, grid="gl"):
    """Complex SH coefficients -> grid function (N, 2N-1), scaled by
    sqrt(4 pi); applies Berezin smoothing multipliers by default
    (reference transforms.py:259-262)."""
    omega = np.ascontiguousarray(omega, dtype=complex_dtype(omega.dtype))
    if N == -1:
        N = ind2elm(omega.shape[0] - 1)[0] + 1
    if omega.shape[0] < N**2:
        omega = np.hstack((omega, np.zeros(N**2 - omega.shape[0], dtype=complex)))
    elif omega.shape[0] > N**2:
        omega = omega[: N**2]
    if berezin:
        bw = berezin_multipliers(N=N, dtype=real_dtype(omega.dtype))
        omega = omega * bw[: omega.shape[0]]
    _, synthesis = _grid_fns(grid)
    f = synthesis(omega, N, reality=isreal)
    return f * np.sqrt(4.0 * np.pi)


def shc2shr(omega_complex):
    """Complex -> real SH coefficients (projection if the signal is not
    real); Condon-Shortley signs as in the reference (transforms.py:271-307)."""
    n = omega_complex.shape[0]
    omega_real = np.zeros(n, dtype=float)
    L = ind2elm(n - 1)[0] + 1
    for el in range(L):
        i0 = elm2ind(el, 0)
        if i0 >= n:
            break
        omega_real[i0] = omega_complex[i0].real
        if el > 0:
            ms = np.arange(1, el + 1)
            valid = elm2ind(el, ms) < n
            ms = ms[valid]
            sgn = (-1.0) ** ms
            omega_real[elm2ind(el, -ms)] = (
                np.sqrt(2) * sgn * omega_complex[elm2ind(el, ms)].imag
            )
            omega_real[elm2ind(el, ms)] = (
                np.sqrt(2) * sgn * omega_complex[elm2ind(el, ms)].real
            )
    return omega_real


def shr2shc(omega_real):
    """Real -> complex SH coefficients (transforms.py:310-349)."""
    n = omega_real.shape[0]
    omega_complex = np.zeros(n, dtype=complex)
    L = ind2elm(n - 1)[0] + 1
    for el in range(L):
        i0 = elm2ind(el, 0)
        if i0 >= n:
            break
        omega_complex[i0] = omega_real[i0]
        if el > 0:
            ms = np.arange(1, el + 1)
            valid = elm2ind(el, ms) < n
            ms = ms[valid]
            sgn = (-1.0) ** ms
            omega_complex[elm2ind(el, -ms)] = (1.0 / np.sqrt(2)) * (
                omega_real[elm2ind(el, ms)] - 1j * omega_real[elm2ind(el, -ms)]
            )
            omega_complex[elm2ind(el, ms)] = (1.0 / np.sqrt(2)) * sgn * (
                omega_real[elm2ind(el, ms)] + 1j * omega_real[elm2ind(el, -ms)]
            )
    return omega_complex


def fun2shr(f, grid="gl"):
    """Grid function -> real SH coefficients."""
    return shc2shr(fun2shc(f, grid=grid))


def shr2fun(omega, N=-1, **kwargs):
    """Real SH coefficients -> grid function (N, 2N-1)."""
    return shc2fun(shr2shc(omega), isreal=True, N=N, **kwargs)


def forward(f, L=None, Spin=0, Method="MW", Reality=False):
    """pyssht-style analysis (the API the reference emulates over ducc0,
    reference quflow/transforms.py:117-149).  Method 'MW' or 'GL'; spin
    transforms are not part of the quflow workload."""
    if Spin != 0:
        raise NotImplementedError("spin-weighted transforms not supported")
    f = np.asarray(f)
    if L is None:
        L = f.shape[0]
    if Method == "MW_pole":
        raise NotImplementedError(
            "Method='MW_pole' ((L+1, 2L-1) sampling) is not supported; "
            "resample to MW or GL first"
        )
    analysis, _ = _grid_fns(Method)
    return analysis(f, L, reality=Reality)


def inverse(flm, L=None, Spin=0, Method="MW", Reality=False):
    """pyssht-style synthesis (reference quflow/transforms.py:151-183)."""
    if Spin != 0:
        raise NotImplementedError("spin-weighted transforms not supported")
    flm = np.asarray(flm)
    if L is None:
        L = int(round(np.sqrt(flm.shape[0])))
    if Method == "MW_pole":
        raise NotImplementedError(
            "Method='MW_pole' ((L+1, 2L-1) sampling) is not supported; "
            "resample to MW or GL first"
        )
    _, synthesis = _grid_fns(Method)
    return synthesis(flm, L, reality=Reality)


def mw2gl(f):
    """Resample a band-limited MW-sampled grid (reference-produced ``fun``
    data) onto the native Gauss-Legendre grid, exactly."""
    f = np.asarray(f)
    L = f.shape[0]
    reality = np.isrealobj(f)
    return shsynthesis(shanalysis_mw(f, L, reality=reality), L, reality=reality)


def gl2mw(f):
    """Resample a band-limited Gauss-Legendre grid onto the reference's MW
    sampling, exactly."""
    f = np.asarray(f)
    L = f.shape[0]
    reality = np.isrealobj(f)
    return shsynthesis_mw(shanalysis(f, L, reality=reality), L, reality=reality)


def fun2img(f, lim=np.inf):
    """2-D float array -> 8-bit image; value 128 corresponds to 0.0."""
    if not isinstance(lim, tuple):
        if lim == np.inf:
            lim = np.abs(f).max()
        lim = (-lim, lim)
    fscale = 255 * (f - lim[0]) / (lim[1] - lim[0])
    return np.clip(fscale, 0, 255).astype(np.uint8)


def img2fun(img, lim=1.0):
    """8-bit image -> 2-D float array."""
    if not isinstance(lim, tuple):
        lim = (-lim, lim)
    return img.astype(float) * (lim[1] - lim[0]) / 255.0 + lim[0]


def as_fun(data, N=-1, **kwargs):
    """Dispatch (mat | fun | img | shr | shc) -> fun."""
    data = np.asarray(data)
    if data.ndim == 2:
        if data.shape[0] == data.shape[1] and np.iscomplexobj(data):
            W = data
            if N == -1:
                N = W.shape[0]
            if np.allclose(W, -W.conj().T):
                return shr2fun(mat2shr(W), N, **kwargs)
            return shc2fun(mat2shc(W), N=N, **kwargs)
        if data.dtype == np.uint8:
            return img2fun(data)
        return data
    if np.iscomplexobj(data):
        return shc2fun(data, **kwargs) if N == -1 else shc2fun(data, N=N, **kwargs)
    return shr2fun(data, **kwargs) if N == -1 else shr2fun(data, N, **kwargs)


def as_shr(data, grid="gl"):
    """Dispatch (mat | fun | img | shr | shc) -> shr.  ``grid`` names the
    sampling of fun/img inputs ('mw' for reference-produced data)."""
    data = np.asarray(data)
    if data.ndim == 2:
        if data.shape[0] == data.shape[1] and np.iscomplexobj(data):
            return mat2shr(data)
        if data.dtype == np.uint8:
            return fun2shr(img2fun(data), grid=grid)
        return fun2shr(data, grid=grid)
    if np.iscomplexobj(data):
        return shc2shr(data)
    return data
