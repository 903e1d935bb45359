#!/usr/bin/env python
"""Quantized spherical MHD on quflow_tpu_torch, the PyTorch/CUDA twin of
examples/mhd_simulation.py: the two-component state (W, Theta) stepped
card-resident by ``MagmpTorch`` (the drop-in integrator over
``build_mhd_step_fn``), then the conservation report: total energy
(kinetic + magnetic), cross helicity tr(W Theta) and Theta's Casimirs.

Run:  python examples/torch_mhd_simulation.py [--N 64] [--steps 500]
      [--dtype complex128] [--device cpu]    (default: the CUDA card)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--N", type=int, default=64)
    parser.add_argument("--lmax", type=int, default=10)
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--stepsize", type=float, default=0.25)
    parser.add_argument("--theta-scale", type=float, default=0.1)
    parser.add_argument("--maxit", type=int, default=10)
    parser.add_argument("--dtype", default="complex64",
                        choices=("complex64", "complex128"),
                        help="the stepper's precision (complex64 runs the "
                             "warm mixed-precision default)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    import numpy as np
    import quflow_tpu_torch as qt
    from quflow_tpu_torch.integrators.mhd import solve_mhd
    from quflow_tpu_torch.models import MHDFlow
    from quflow_tpu_torch.parallel import MagmpTorch

    flow = MHDFlow(N=args.N)
    state0 = flow.random_initial(lmax=args.lmax, seed=42,
                                 theta_scale=args.theta_scale)
    dt = args.stepsize * flow.hbar

    def inner(A, B):
        return float(np.sum(A * np.conj(B)).real) / args.N

    def energies(state):
        W, Theta = state
        P, B = solve_mhd(state, device=args.device)
        kinetic = float(qt.energy_euler(W, device=args.device))
        magnetic = -0.5 * inner(np.asarray(B), Theta)
        return kinetic, magnetic, inner(W, Theta)

    k0, m0, c0 = energies(state0)
    print(f"N={args.N}: kinetic {k0:.6f}, magnetic {m0:.6f}, "
          f"cross helicity {c0:.6f}")

    integ = MagmpTorch(maxit=args.maxit, dtype=np.dtype(args.dtype),
                       device=args.device)
    state = integ(state0.astype(args.dtype), dt, steps=args.steps).astype(
        state0.dtype)

    k1, m1, c1 = energies(state)
    s0 = np.sort(np.linalg.eigvalsh(-1j * state0[1]))
    s1 = np.sort(np.linalg.eigvalsh(-1j * state[1]))
    print(f"after {args.steps} MagmpTorch steps ({args.dtype}, dt = "
          f"{args.stepsize}*hbar, captured: {integ.captured}):")
    print(f"  total energy drift:   {k1 + m1 - (k0 + m0):+.3e}")
    print(f"  cross-helicity drift: {c1 - c0:+.3e}")
    # In MHD only Theta's Casimirs survive (W exchanges with the magnetic
    # field through the Lorentz term); magmp conserves them structurally.
    print(f"  Casimir drift (Theta): {np.abs(s1 - s0).max():.3e}")
    return dict(energy_drift=k1 + m1 - (k0 + m0),
                casimir_drift=np.abs(s1 - s0).max())


if __name__ == "__main__":
    main()
