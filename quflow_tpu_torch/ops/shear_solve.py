"""The column solve of the shear layout as its callers reach it: which
kernel runs (:func:`column_solver`), the host-prefactorized operator of
each solve family (:func:`_shear_factors_cached`; in the row layouts
:func:`row_factors`), and the copies of its factors on a device
(:func:`device_factors`, :func:`device_row_factors`), kept in
:data:`device_cache`, which ops/laplacian.py, ops/tridiag.py and
ops/diagpack.py share for their device operators and index maps.

The Poisson family's backend (ops/laplacian.py) and the production
steppers (parallel/stepper.py) both solve through here, so the kernel
choice and the factor caches are one for the whole package.
"""

from __future__ import annotations

import contextlib
import os
from collections import OrderedDict
from functools import lru_cache

import numpy as np
import torch

from .. import config
from .cuda_scan_solve import shear_scan
from .cuda_solve import shear_thomas
from .geometry import hbar
from .tridiag import TridiagFactors, packed_laplacian, shear_operator

__all__ = ["column_solver", "device_factors", "device_row_factors",
           "row_factors", "device_cache", "real_dtype", "to_device",
           "DEVICE_CACHE_BYTES"]

#: bytes of device operators that :data:`device_cache` keeps, on all
#: devices together.  One complex128 factor set at N=8192 is
#: 3 N (N+1) 8 B = 1.6 GB, so two of them fit.
DEVICE_CACHE_BYTES = 4 << 30


def column_solver(solver=None):
    """The column solve ``(w, binv, u, d) -> x`` that a caller uses.

    An explicit ``solver`` wins.  Otherwise ``QUFLOW_PALLAS_KERNEL`` is read
    at the call: 'thomas' (the default) selects
    ops.cuda_solve.shear_thomas, 'scan' ops.cuda_scan_solve.shear_scan;
    any other value raises ValueError.  Both launch their CUDA kernel on a
    CUDA tensor and run their plain version on a CPU tensor.

    One difference from quflow_tpu: there the variable acts only where the
    layout resolves to 'shear_pallas' (on the TPU, N >= 4096, or when
    named) and any other value silently means 'thomas'.  Here it acts on
    every single-device shear solve, since every one is a kernel.  A solve
    whose rows are split over a mesh's 'tp' > 1 ranks
    (parallel/shard_shear.py) launches ops.cuda_block_solve.shear_block
    whatever the variable says."""
    if solver is not None:
        return solver
    name = os.environ.get("QUFLOW_PALLAS_KERNEL", "thomas")
    if name == "thomas":
        return shear_thomas
    if name == "scan":
        return shear_scan
    raise ValueError(f"QUFLOW_PALLAS_KERNEL={name!r}: use 'thomas' or 'scan'")


def real_dtype(dtype):
    """The real working dtype (numpy) of complex state ``dtype``."""
    try:
        return config.TIERS[config.numpy_dtype(dtype)]
    except KeyError:
        raise ValueError(
            f"dtype {dtype!r}: use complex64 or complex128") from None


def to_device(a, rdtype, device):
    """Host array -> contiguous tensor on ``device``, cast by numpy (as
    quflow_tpu casts its host operators)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(rdtype))
                            ).to(device)


@lru_cache(maxsize=256)
def _shear_factors_cached(N, kind="poisson", params=()):
    """Host-prefactorized shear-layout operator for a solve family
    (``kind``/``params`` as in ops/tridiag.shear_operator; Poisson by
    default): factors transposed to (N, N+1) for the column solve,
    refinement op channel-first (2, N, N+1) in float64.  A numpy copy of
    quflow_tpu/parallel/stepper.py:344-360; 256 operator sets are kept, as
    quflow_tpu/ops/laplacian.py:58 keeps them."""
    op_bc = shear_operator(N, kind, params)
    fac = TridiagFactors(op_bc)
    # refinement must evaluate residuals of the SAME (bc'd) system the base
    # solve factorizes, in float64
    op_cols = np.stack([op_bc[:, 0, :].T, op_bc[:, 1, :].T]).astype(np.float64)
    return (
        np.ascontiguousarray(fac.w.T),
        np.ascontiguousarray(fac.binv.T),
        np.ascontiguousarray(fac.u.T),
        op_cols,
    )


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class DeviceCache:
    """Least-recently-used tensors on devices, bounded in bytes by
    :data:`DEVICE_CACHE_BYTES` (read at each insertion).  A value is a
    tuple of tensors; one larger than the whole budget is returned to its
    caller and not kept."""

    def __init__(self):
        self._values = OrderedDict()
        self.nbytes = 0
        self._held = []  # the dicts of the open hold() blocks

    @contextlib.contextmanager
    def hold(self, held):
        """Inside the block, :meth:`get` answers from the dict ``held``
        first and puts every value it returns there.  A captured CUDA graph
        (parallel/capture.py) keeps its ``held`` for as long as it lives:
        an eviction then cannot free an operator the graph reads, and a
        capture, which may not copy from the host, never rebuilds one its
        warm-up made."""
        self._held.append(held)
        try:
            yield
        finally:
            self._held.pop()

    def get(self, key, build):
        """The value of ``key``, made by ``build()`` on a miss."""
        if self._held and key in self._held[-1]:
            return self._held[-1][key]
        value = self._get(key, build)
        if self._held:
            self._held[-1][key] = value
        return value

    def _get(self, key, build):
        value = self._values.get(key)
        if value is not None:
            self._values.move_to_end(key)
            return value
        value = build()
        size = _nbytes(value)
        if size > DEVICE_CACHE_BYTES:
            return value
        while self._values and self.nbytes + size > DEVICE_CACHE_BYTES:
            self.nbytes -= _nbytes(self._values.popitem(last=False)[1])
        self._values[key] = value
        self.nbytes += size
        return value

    def clear(self):
        self._values.clear()
        self.nbytes = 0

    def __len__(self):
        return len(self._values)


#: the device operators of the package: the column factors of every solve
#: family, the shear Laplacian, the semiseparable m=0 inverses
device_cache = DeviceCache()


def device_factors(N, kind, params, rdtype, device):
    """``(w, binv, u)`` of :func:`_shear_factors_cached` cast to the real
    dtype ``rdtype`` (numpy) on ``device`` (a torch.device), kept in
    :data:`device_cache`: a solve inside a loop (a Strang hook's
    ``solve_heat``, every fixed-point iteration's Hamiltonian) then uploads
    nothing while its set stays in the budget."""
    def build():
        w, binv, u, _ = _shear_factors_cached(N, kind, params)
        return tuple(to_device(a, rdtype, device) for a in (w, binv, u))

    return device_cache.get(("factors", N, kind, tuple(params),
                             np.dtype(rdtype), torch.device(device)), build)


@lru_cache(maxsize=256)
def row_factors(N, skewh, kind="poisson", params=()):
    """The prefactorized operator of a solve family in a row layout:
    ``TridiagFactors`` of the (R, 2, N) packed operator, R = N//2+1
    (``skewh``) or N (the wrapped layouts).  A numpy copy of
    quflow_tpu/ops/laplacian.py:58-90 (``_factors``)."""
    from .diagpack import num_rows, pack_indices

    R = num_rows(N, skewh)
    lap = packed_laplacian(N, nrows=R, bc=(kind == "poisson"))
    if kind == "poisson":
        op = lap
    elif kind == "heat":
        (h_nu,) = params
        op = -h_nu * lap
        op[:, 0, :] += 1.0
    elif kind == "helmholtz":
        (alpha,) = params
        op = -alpha * lap
        op[:, 0, :] += 1.0
    elif kind == "viscdamp":
        h, nu, alpha, theta = params
        op = -(h * nu * theta) * lap
        op[:, 0, :] += 1.0 + h * alpha * theta
    elif kind == "globalqg":
        (gamma,) = params
        op = lap.copy()
        s = (N - 1) / 2
        z = hbar(N) * np.arange(-s, s + 1)
        rows, cols = pack_indices(N, skewh)
        op[:, 0, :] -= (gamma / 2.0) * (z[rows] ** 2 + z[cols] ** 2)
    else:
        raise ValueError(f"unknown solve family {kind!r}")
    return TridiagFactors(op)


def row_factors_host(N, rdtype, pad_rows=0, with_op=False, wrapped=False,
                     kind="poisson", params=()):
    """``(w, binv, u, op)`` of :func:`row_factors` for the stepper's row
    layouts: the factors cast to ``rdtype`` (numpy), the (R, 2, N)
    refinement operator float64 (None without ``with_op``), and
    ``pad_rows`` pad rows that solve the identity (w = u = 0, binv = 1;
    op main 1), as quflow_tpu/parallel/stepper.py:384-405 fills them."""
    rd = np.dtype(rdtype)
    fac = row_factors(N, not wrapped, kind, tuple(params))
    w, binv, u = fac.w.astype(rd), fac.binv.astype(rd), fac.u.astype(rd)
    op = fac.op.astype(np.float64) if with_op else None
    if pad_rows:
        Npts = w.shape[-1]
        w = np.vstack([w, np.zeros((pad_rows, Npts), rd)])
        binv = np.vstack([binv, np.ones((pad_rows, Npts), rd)])
        u = np.vstack([u, np.zeros((pad_rows, Npts), rd)])
        if op is not None:
            pad_op = np.zeros((pad_rows, 2, Npts), np.float64)
            pad_op[:, 0, :] = 1.0
            op = np.concatenate([op, pad_op], axis=0)
    return w, binv, u, op


def device_row_factors(N, kind, params, rdtype, device, wrapped, pad_rows=0,
                       with_op=False):
    """:func:`row_factors_host` on ``device``: ``(w, binv, u)`` in
    ``rdtype``, and with ``with_op`` the float64 operator, kept in
    :data:`device_cache` under the layout (wrapped or not) and the pad
    rows."""
    def build():
        w, binv, u, op = row_factors_host(N, rdtype, pad_rows, with_op,
                                          wrapped, kind, params)
        out = tuple(to_device(a, rdtype, device) for a in (w, binv, u))
        if with_op:
            out += (torch.from_numpy(op).to(device),)
        return out

    return device_cache.get(("row_factors", N, kind, tuple(params),
                             bool(wrapped), int(pad_rows), bool(with_op),
                             np.dtype(rdtype), torch.device(device)), build)
