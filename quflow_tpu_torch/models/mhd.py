"""Quantized magnetohydrodynamics on the sphere: the two-component state
(W, Theta), stepped by the magnetic midpoint method.

Counterpart of quflow_tpu/models/mhd.py: the reference-semantics
``hamiltonian`` and ``step`` (integrators/mhd.py), ``random_initial``, and
the production ``stepper``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..analysis import random_shr
from ..integrators.mhd import magmp_fixedpoint, solve_mhd
from ..quantization import shr2mat
from .euler import EulerFlow


@dataclass
class MHDFlow(EulerFlow):
    """Quantized MHD flow at band limit N; the state is
    ``np.stack([W, Theta])`` (2, N, N)."""

    def hamiltonian(self, state, *, device=None):
        return solve_mhd(state, device=device)

    def random_initial(self, lmax=10, s=1.0, theta_scale=0.1, seed=42,
                       **kwargs):
        """Random smooth band-limited (W, Theta), Theta scaled by
        ``theta_scale`` (numpy, ``dtype``)."""
        W = shr2mat(random_shr(lmax=lmax, s=s, seed=seed), N=self.N)
        Theta = theta_scale * shr2mat(
            random_shr(lmax=lmax, s=s, seed=seed + 1), N=self.N
        )
        return np.stack([W, Theta]).astype(self.dtype)

    def step(self, state, dt, steps=1, **kwargs):
        """Advance ``steps`` magnetic midpoint steps (``magmp``; its
        options, ``device=`` among them, pass through ``kwargs``)."""
        return magmp_fixedpoint(state, dt, steps=steps, **kwargs)

    def stepper(self, dt, steps, maxit=5, minit=5, compsum=True, *,
                device=None, **kwargs):
        """The port's multi-step runner ``fn(S, dS, csum)`` on ``device``
        (see parallel/stepper.build_mhd_step_fn; other options pass
        through ``kwargs``).  quflow_tpu's MHDFlow inherits the Euler
        stepper, with these parameters; this one steps both components."""
        from ..parallel.stepper import build_mhd_step_fn

        return build_mhd_step_fn(self.N, dt, steps=steps, maxit=maxit,
                                 dtype=self.dtype, compsum=compsum,
                                 minit=minit, device=device, **kwargs)
