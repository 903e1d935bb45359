"""Spherical-harmonic transform on the device (Gauss-Legendre grid).

Counterpart of quflow_tpu/ops/sht_jax.py and device counterpart of
ops/sht.py, for on-device visualization pipelines and differentiable
objectives: the per-m Legendre contractions become one einsum against a
precomputed (L, ntheta, L) tensor and the longitude transform a
``torch.fft`` - no host round trip.

Suitable for moderate band limits: the tensor holds L^3 reals (L=256:
134 MB in float64, 67 MB in float32); the host implementation remains the
general path.  The builders keep quflow_tpu's split-plane I/O,
coefficients (2, L^2) in and a grid (2, L, 2L-1) out and back, so that
they are drop-in; they run on the CUDA device by default (``device=``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import config
from .sht import legendre_blocks, _gl

__all__ = ["build_synthesis_fn", "build_analysis_fn", "legendre_tensor"]


@lru_cache(maxsize=8)
def legendre_tensor(L, dtype_str="float64"):
    """(L, ntheta, L) numpy tensor P with P[m, k, l-m] = Pbar_lm(x_k),
    zero-padded, and the quadrature weights (ntheta,)."""
    x, wq = _gl(L)
    T = np.zeros((L, L, L), dtype=np.dtype(dtype_str))
    for m, block in legendre_blocks(L, x):
        T[m, :, : L - m] = block
    return T, wq.astype(np.dtype(dtype_str))


@lru_cache(maxsize=8)
def _flm_maps(L):
    """Index maps between the flat pyssht layout and the (m, l-m) grid:
    ``pos``/``neg`` (l^2 + l +- m), ``valid`` (l >= m) and the
    Condon-Shortley sign (-1)^m of the negative-m Legendre functions."""
    lidx = np.arange(L) * (np.arange(L) + 1)
    pos = np.zeros((L, L), dtype=np.int64)
    neg = np.zeros((L, L), dtype=np.int64)
    valid = np.zeros((L, L), dtype=bool)
    for m in range(L):
        for l in range(m, L):
            pos[m, l - m] = lidx[l] + m
            neg[m, l - m] = lidx[l] - m
            valid[m, l - m] = True
    csphase = (-1.0) ** np.arange(L)
    return pos, neg, valid, csphase


def _setup(L, dtype, device, weighted):
    """(device, real dtype, the Legendre tensor (quadrature-weighted when
    ``weighted``), pos, neg, valid, the sign) on the device."""
    rd = np.dtype(dtype)
    dev = config.device(device)
    T, wq = legendre_tensor(L, str(rd))
    if weighted:
        T = T * wq[None, :, None]
    pos, neg, valid, cs = _flm_maps(L)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (dev, config.torch_dtype(rd), put(T), put(pos), put(neg),
            put(valid), put(cs.astype(rd)))


def _complex_planes(planes, dev, rd):
    """Split planes (2, ...) (numpy or tensor) -> a complex tensor on
    ``dev`` in the real dtype ``rd``'s complex type."""
    p = torch.as_tensor(planes).to(dev, rd)
    return torch.complex(p[0], p[1])


def _contract(T, c, subscripts):
    """The einsum of the real tensor ``T`` with the complex ``c``, on the
    real and imaginary parts as one trailing axis (T stays real)."""
    out = torch.einsum(subscripts, T, torch.view_as_real(c))
    return torch.view_as_complex(out.contiguous())


def build_synthesis_fn(L, dtype=np.float64, reality=True, *, device=None):
    """flm planes (2, L^2) -> grid planes (2, L, 2L-1) in ``dtype`` on
    ``device`` (the imaginary plane is zero for ``reality``)."""
    dev, rd, T, pos, neg, valid, cs = _setup(L, dtype, device, False)
    nphi = 2 * L - 1

    def synthesis(flm_planes):
        flm = _complex_planes(flm_planes, dev, rd)
        # both signs of m in one contraction: (2, m, l-m) -> (2, theta, m)
        c = torch.stack([flm[pos], flm[neg] * cs[:, None]]) * valid
        Gpos, Gneg = _contract(T, c, "mkl,smlr->skmr")
        G = torch.cat([Gpos, Gneg[:, 1:].flip(-1)], dim=-1)
        f = torch.fft.ifft(G, dim=-1) * nphi
        if reality:
            return torch.stack([f.real, torch.zeros_like(f.real)])
        return torch.stack([f.real, f.imag])

    return synthesis


def build_analysis_fn(L, dtype=np.float64, reality=True, *, device=None):
    """grid planes (2, L, 2L-1) -> flm planes (2, L^2) in ``dtype`` on
    ``device``.  With ``reality`` the coefficients are projected onto
    those of a real signal, f(l, -m) = (-1)^m conj f(l, m), with real
    m = 0 coefficients, as the host path does."""
    dev, rd, Tw, pos, neg, valid, cs = _setup(L, dtype, device, True)
    nphi = 2 * L - 1
    mneg = valid.clone()
    mneg[0] = False  # m = 0 is stored once, at pos
    idx = torch.cat([pos[valid], neg[mneg]])

    def analysis(f_planes):
        f = _complex_planes(f_planes, dev, rd)
        F = torch.fft.fft(f, dim=-1) * (2.0 * np.pi / nphi)
        Fs = torch.stack([F[:, :L], torch.cat([F[:, :1],
                                               F[:, nphi - L + 1:].flip(-1)],
                                              dim=-1)])
        cpos, cneg = _contract(Tw, Fs, "mkl,skmr->smlr")
        cneg = cneg * cs[:, None]
        if reality:
            # the coefficient stored at neg: cneg for m > 0, cpos for m = 0
            fneg = torch.cat([cpos[:1], cneg[1:]])
            cpos = 0.5 * (cpos + cs[:, None] * fneg.conj())
            cneg = cs[:, None] * cpos.conj()
            cpos[0] = cpos[0].real.to(cpos.dtype)
        flm = torch.zeros(L * L, dtype=f.dtype, device=dev)
        flm = flm.index_add(0, idx, torch.cat([cpos[valid], cneg[mneg]]))
        return torch.stack([flm.real, flm.imag])

    return analysis
