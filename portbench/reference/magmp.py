"""The magnetic midpoint scheme for quantized MHD, plainly.

The state is (W, Theta): W' = [P, W] + [B, Theta], Theta' = [P, Theta]
with P = Delta^-1 W and B = Delta Theta.  The midpoint relation is
isomp's (reference/isomp.py) on both components, plus
(B T) P - ((B T) P)^H + B T - (B T)^H in W's dW and 2 (B T - (B T)^H) in
W's update, T = Theta_half.  States are (..., 2, N, N).
"""

from __future__ import annotations

import torch

from portbench.reference.scheme import Midpoint

__all__ = ["Scheme"]


class Scheme(Midpoint):
    def iterate(self, S, dS, eps):
        Sh = S + dS
        Wh, Th = Sh[..., 0, :, :], Sh[..., 1, :, :]
        P = eps * self.lap.solve(Wh)
        B = eps * self.lap.apply(Th)
        PS = torch.matmul(P.unsqueeze(-3), Sh)
        PSc = PS - PS.mH
        BT = torch.matmul(B, Th)
        BTc = BT - BT.mH
        BTP = torch.matmul(BT, P)
        dS_new = torch.matmul(PS, P.unsqueeze(-3)) + PSc
        dS_new[..., 0, :, :] += BTP - BTP.mH + BTc
        upd = 2.0 * PSc
        upd[..., 0, :, :] += 2.0 * BTc
        return dS_new, upd
