#!/usr/bin/env python
"""End-to-end demo on quflow_tpu_torch, the PyTorch/CUDA twin of
examples/basic_simulation.py: the reference's 'basic simulation'
workflow (notebooks/basic-simulation).

Random smooth initial vorticity -> isospectral midpoint integration
(``solve`` with its default ``isomp`` on the card) with energy/enstrophy
logging -> conservation report.  The log goes to HDF5 through
``QuSimulation`` where h5py imports; without it the run says so and logs
in memory.

Run:  python examples/torch_basic_simulation.py [--N 128] [--simtime 5.0]
      [--device cpu]    (default: the CUDA card)
"""

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class MemoryLog:
    """A solve callback in place of QuSimulation: the loggers' values,
    steps and times of each output, and the last state."""

    def __init__(self, loggers):
        self.loggers = loggers
        self.rows = {name: [] for name in loggers}
        self.step, self.time = [0], [0.0]
        self.state = None

    def __call__(self, W, delta_time=0.0, delta_steps=0, **stats):
        if delta_steps:
            self.step.append(self.step[-1] + delta_steps)
            self.time.append(self.time[-1] + delta_time)
        for name, fn in self.loggers.items():
            self.rows[name].append(float(fn(W)))
        self.state = W


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--N", type=int, default=128)
    parser.add_argument("--lmax", type=int, default=10)
    parser.add_argument("--simtime", type=float, default=5.0)
    parser.add_argument("--stepsize", type=float, default=0.25)
    parser.add_argument("--steps-out", type=int, default=50)
    parser.add_argument("--outfile", default="torch_basic_simulation.hdf5")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    import numpy as np
    import quflow_tpu_torch as qt
    from quflow_tpu_torch.models import EulerFlow

    flow = EulerFlow(N=args.N)
    W0 = flow.random_initial(lmax=args.lmax, seed=42)
    energy = functools.partial(qt.energy_euler, device=args.device)
    loggers = {"energy": energy, "enstrophy": qt.enstrophy}
    print(f"N={args.N}, initial energy {float(energy(W0)):.6f}, "
          f"enstrophy {float(qt.enstrophy(W0)):.6f}")

    try:
        import h5py  # noqa: F401
    except ImportError:
        log = MemoryLog(loggers)
        log(W0)
        print("h5py does not import: no HDF5 file, the log is kept in memory")
    else:
        log = qt.QuSimulation(args.outfile, overwrite=True, state=W0,
                              loggers=loggers)
    qt.solve(W0.copy(), stepsize=args.stepsize, simtime=args.simtime,
             steps_out=args.steps_out, callback=log, progress_bar=False,
             device=args.device)

    if isinstance(log, MemoryLog):
        Wf, step, time = log.state, log.step[-1], log.time[-1]
        E, Z = log.rows["energy"], log.rows["enstrophy"]
    else:
        Wf, step, time = log["mat", -1], log["step"][-1], log["time"][-1]
        E, Z = log["energy"], log["enstrophy"]
    c0 = np.sort(np.linalg.eigvalsh(-1j * W0))
    c1 = np.sort(np.linalg.eigvalsh(-1j * np.asarray(Wf)))
    print(f"steps: {step},  time: {time:.4f}s")
    print(f"energy drift:    {E[-1] - E[0]:+.3e}")
    print(f"enstrophy drift: {Z[-1] - Z[0]:+.3e}")
    print(f"spectral (Casimir) drift: {np.abs(c1 - c0).max():.3e}")
    return dict(steps=int(step), energy=np.asarray(E),
                enstrophy=np.asarray(Z), casimir_drift=np.abs(c1 - c0).max())


if __name__ == "__main__":
    main()
