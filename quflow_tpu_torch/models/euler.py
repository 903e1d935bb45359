"""The flagship model: 2-D incompressible Euler on the sphere, quantized.

Counterpart of quflow_tpu/models/euler.py: ``random_initial``, ``hbar`` and
``stepper``.  The reference-semantics ``hamiltonian``/``step``/``stepsize``
wait for the port of integrators/isospectral.py and ops/laplacian.py
(ROADMAP A6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..analysis import random_shr
from ..ops.geometry import hbar
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

    @property
    def hbar(self):
        return hbar(self.N)

    def random_initial(self, lmax=10, s=1.0, gamma=0.0, seed=42):
        """Random smooth band-limited vorticity (numpy, ``dtype``)."""
        omega0 = random_shr(lmax=lmax, s=s, gamma=gamma, seed=seed)
        return shr2mat(omega0, N=self.N).astype(self.dtype)

    def stepper(self, dt, steps, maxit=5, compsum=True, *, device=None,
                **kwargs):
        """The port's multi-step runner ``fn(W, dW, csum)`` on ``device``
        (see parallel/stepper.build_step_fn; other options pass through
        ``kwargs``)."""
        from ..parallel.stepper import build_step_fn

        return build_step_fn(self.N, dt, steps=steps, maxit=maxit,
                             dtype=self.dtype, compsum=compsum, device=device,
                             **kwargs)
