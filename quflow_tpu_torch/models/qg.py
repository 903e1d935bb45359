"""Global quasi-geostrophic flow: Euler dynamics with the QG stream
operator (Delta - (gamma/2)(Z^2 . + . Z^2))^-1 as Hamiltonian (reference
cpu.py:829-877 ``solve_globalqg``).

Counterpart of quflow_tpu/models/qg.py: ``hamiltonian`` and ``step``
(``isomp`` with ``solve_globalqg``), and the production ``stepper`` with
the QG operator as the named Hamiltonian ``('globalqg', gamma)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

from ..integrators.isospectral import isomp_fixedpoint
from ..ops.laplacian import solve_globalqg
from .euler import EulerFlow


@dataclass
class GlobalQGFlow(EulerFlow):
    gamma: float = 1.0

    def hamiltonian(self, W, *, device=None):
        return solve_globalqg(W, gamma=self.gamma, skewh=True, device=device)

    def step(self, W, dt, steps=1, **kwargs):
        """Advance ``steps`` isospectral midpoint steps with the QG stream
        operator (``isomp``; its options pass through ``kwargs``)."""
        ham = partial(solve_globalqg, gamma=self.gamma, skewh=True)
        return isomp_fixedpoint(W, dt, steps=steps, hamiltonian=ham, **kwargs)

    def stepper(self, dt, steps, maxit=5, minit=5, compsum=True,
                forcing=None, strang_splitting=None, *, device=None,
                **kwargs):
        """The production runner with the prefactorized QG stream operator
        as Hamiltonian, solved like Poisson on the shear layout; ``forcing``
        and ``strang_splitting`` hook the forced-dissipative QG
        configuration into the same step (see
        parallel.stepper.build_step_fn)."""
        from ..parallel.stepper import build_step_fn

        return build_step_fn(
            self.N, dt, steps=steps, maxit=maxit, dtype=self.dtype,
            compsum=compsum, minit=minit,
            hamiltonian=("globalqg", float(self.gamma)), forcing=forcing,
            strang_splitting=strang_splitting, device=device, **kwargs)
