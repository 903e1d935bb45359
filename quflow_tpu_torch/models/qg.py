"""Global quasi-geostrophic flow: Euler dynamics with the QG stream
operator (Delta - (gamma/2)(Z^2 . + . Z^2))^-1 as Hamiltonian (reference
cpu.py:829-877 ``solve_globalqg``).

Counterpart of quflow_tpu/models/qg.py: ``hamiltonian`` and ``step``
(``isomp`` with ``solve_globalqg``).  The production ``stepper`` waits for
named Hamiltonians on the port's step builder (ROADMAP A7).
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

    def stepper(self, dt, steps, maxit=5, compsum=True, **kwargs):
        raise NotImplementedError(
            "GlobalQGFlow.stepper needs the QG operator as a named "
            "Hamiltonian of parallel.stepper.build_step_fn, not ported to "
            "quflow_tpu_torch yet (ROADMAP.md A7); step with "
            "GlobalQGFlow.step")
