"""What the midpoint schemes of the reference share: the fixed-point
loop of a step, its two exit rules and quflow's tol='auto'.  A scheme is
``reference/<name>.py`` (``isomp.py``, ``magmp.py``), found by the name a
configuration's ``scheme`` gives: its class ``Scheme(Midpoint)`` takes
(N, device) and gives ``iterate``, one fixed-point iteration, on the
members' states as the harness holds them, (B, C, N, N) in complex128.

Two ways to end a step's iteration:

* ``converged``: from the last step's dW (zero at the first), until the
  change of dW stops shrinking or is within a few roundings of dW: the
  exact midpoint step (to 1e-13 of dW), which a fixed iteration count
  from a warm start approaches;
* ``adaptive``: quflow's rule, the one ``isomp`` takes: dW zero at the
  start of a call, stop once i >= minit and the change's matrix
  inf-norm r satisfies r <= tol or r >= r_previous, or at i = maxit;
  tol = sqrt(eps_f32) (dt / hbar) ||W_0||_inf for a complex64 state at
  tol='auto' without compensated sums.
"""

from __future__ import annotations

import numpy as np
import torch

from .quantized import Laplacian, hbar

__all__ = ["Midpoint", "auto_tol", "inf_norm"]


def inf_norm(X):
    """The largest matrix inf-norm (row sums of |x|) over the leading
    axes of X."""
    return X.abs().sum(dim=-1).amax()


def auto_tol(W0, dt, N, state_dtype, compensated=False):
    """quflow's tol='auto' for the state W0 (its first matrix)."""
    eps = float(np.finfo(state_dtype).eps)
    if not compensated:
        eps = float(np.sqrt(eps))
    first = W0.reshape(-1, N, N)[0]
    return float(np.float32(eps * dt / hbar(N) * float(inf_norm(first))))


class Midpoint:
    """A midpoint scheme at N on ``device``, in complex128; ``iterate``
    is the scheme's own."""

    def __init__(self, N, device="cpu"):
        self.N = N
        self.lap = Laplacian(N, device)

    def iterate(self, S, dS, eps):
        """One fixed-point iteration: (dS_new, the update of S)."""
        raise NotImplementedError

    def run(self, S, dt, steps, rule="converged", tol=None, maxit=10,
            minit=1):
        """``steps`` steps from S; returns (S, iterations of each step)."""
        eps = dt / (2.0 * hbar(self.N))
        dS = torch.zeros_like(S)
        counts = []
        for _ in range(steps):
            if rule == "converged":
                r_old = float("inf")
                for i in range(1, 41):
                    dS_new, upd = self.iterate(S, dS, eps)
                    r = float((dS_new - dS).abs().amax())
                    dS = dS_new
                    if r <= 1e-13 * float(dS.abs().amax()) or (
                            i >= 3 and r >= r_old):
                        break
                    r_old = r
            else:
                i, r, r_old = 0, float("inf"), float("inf")
                while i < maxit and not (i >= minit and (r <= tol
                                                         or r >= r_old)):
                    dS_new, upd = self.iterate(S, dS, eps)
                    r_old, r = r, float(inf_norm(dS_new - dS))
                    dS = dS_new
                    i += 1
            S = S + upd
            counts.append(i)
        return S, counts
