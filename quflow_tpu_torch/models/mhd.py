"""Quantized magnetohydrodynamics on the sphere: the two-component state
(W, Theta), stepped by the magnetic midpoint method.

Counterpart of quflow_tpu/models/mhd.py: ``random_initial`` and
``stepper``.  The reference-semantics ``hamiltonian`` and ``step`` wait
for the port of integrators/mhd.py, which needs ops/laplacian.py
(ROADMAP A6), and raise until then.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..analysis import random_shr
from ..quantization import shr2mat
from .euler import EulerFlow


def _needs_a6(name):
    raise NotImplementedError(
        f"MHDFlow.{name} needs integrators/mhd.py and ops/laplacian.py, not "
        "ported to quflow_tpu_torch yet (ROADMAP.md A6); step with "
        "MHDFlow.stepper or parallel.stepper.MagmpTorch")


@dataclass
class MHDFlow(EulerFlow):
    """Quantized MHD flow at band limit N; the state is
    ``np.stack([W, Theta])`` (2, N, N)."""

    def random_initial(self, lmax=10, s=1.0, theta_scale=0.1, seed=42,
                       **kwargs):
        """Random smooth band-limited (W, Theta), Theta scaled by
        ``theta_scale`` (numpy, ``dtype``)."""
        W = shr2mat(random_shr(lmax=lmax, s=s, seed=seed), N=self.N)
        Theta = theta_scale * shr2mat(
            random_shr(lmax=lmax, s=s, seed=seed + 1), N=self.N
        )
        return np.stack([W, Theta]).astype(self.dtype)

    def hamiltonian(self, state):
        _needs_a6("hamiltonian")

    def step(self, state, dt, steps=1, **kwargs):
        _needs_a6("step")

    def stepper(self, dt, steps, maxit=5, compsum=True, *, device=None,
                **kwargs):
        """The port's multi-step runner ``fn(S, dS, csum)`` on ``device``
        (see parallel/stepper.build_mhd_step_fn; other options pass
        through ``kwargs``)."""
        from ..parallel.stepper import build_mhd_step_fn

        return build_mhd_step_fn(self.N, dt, steps=steps, maxit=maxit,
                                 dtype=self.dtype, compsum=compsum,
                                 device=device, **kwargs)
