"""The isospectral midpoint scheme (Modin & Viviani, JFM 884 A22, 2020)
for the quantized Euler equations, plainly.

W' = [P, W], P = Delta^-1 W.  A step of size dt, with eps = dt / (2 hbar),
solves the midpoint relation

    W_half = W + dW,  P = eps Delta^-1 W_half,
    dW = (P W_half) P + P W_half - (P W_half)^H

by fixed-point iteration and sets W_next = W + 2 (P W_half - (P W_half)^H)
from the last iterate.  States are (..., N, N).
"""

from __future__ import annotations

import torch

from portbench.reference.scheme import Midpoint

__all__ = ["Scheme"]


class Scheme(Midpoint):
    def iterate(self, S, dS, eps):
        Wh = S + dS
        P = eps * self.lap.solve(Wh)
        PW = torch.matmul(P, Wh)
        PWc = PW - PW.mH
        return torch.matmul(PW, P) + PWc, 2.0 * PWc
