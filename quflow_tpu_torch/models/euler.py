"""The flagship model: 2-D incompressible Euler on the sphere, quantized.

Counterpart of quflow_tpu/models/euler.py: the reference-semantics
``hamiltonian``, ``stepsize`` and ``step`` (the Poisson solve of
ops/laplacian.py and ``isomp``), ``random_initial``, ``hbar``, and the
production ``stepper``.  The reference-semantics methods take a numpy
state to ``device`` (the card by default) or keep a tensor on its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..analysis import random_shr
from ..integrators.isospectral import estimate_stepsize, isomp_fixedpoint
from ..ops.geometry import hbar
from ..ops.laplacian import solve_poisson
from ..quantization import shr2mat


@dataclass
class EulerFlow:
    """Quantized Euler flow at band limit N.

    Parameters
    ----------
    N: matrix size (band limit + 1)
    dtype: complex state dtype (complex128 for the accuracy gates,
        complex64 for the fast tier)
    """

    N: int
    dtype: np.dtype = np.complex128

    def hamiltonian(self, W, *, device=None):
        return solve_poisson(W, skewh=True, device=device)

    @property
    def hbar(self):
        return hbar(self.N)

    def random_initial(self, lmax=10, s=1.0, gamma=0.0, seed=42):
        """Random smooth band-limited vorticity (numpy, ``dtype``)."""
        omega0 = random_shr(lmax=lmax, s=s, gamma=gamma, seed=seed)
        return shr2mat(omega0, N=self.N).astype(self.dtype)

    def stepsize(self, W, safety_factor=0.1, *, device=None):
        return estimate_stepsize(W, safety_factor=safety_factor,
                                 device=device)

    def step(self, W, dt, steps=1, **kwargs):
        """Advance ``steps`` isospectral midpoint steps (``isomp``; its
        options, ``device=`` among them, pass through ``kwargs``)."""
        return isomp_fixedpoint(W, dt, steps=steps, **kwargs)

    def stepper(self, dt, steps, maxit=5, minit=5, compsum=True, *,
                device=None, **kwargs):
        """The port's multi-step runner ``fn(W, dW, csum)`` on ``device``
        (see parallel/stepper.build_step_fn).  The hooks (``forcing``,
        ``strang_splitting``, ``hamiltonian``), ``tol`` and the other
        options pass through ``kwargs``; ``minit`` acts only with
        ``tol``."""
        from ..parallel.stepper import build_step_fn

        return build_step_fn(self.N, dt, steps=steps, maxit=maxit,
                             dtype=self.dtype, compsum=compsum, minit=minit,
                             device=device, **kwargs)
