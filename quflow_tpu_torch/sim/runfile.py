"""Standalone runfile generation.

Counterpart of quflow_tpu/sim/runfile.py ``create_runfile`` (reference
quflow/simulation.py:485-577): emits a self-contained CLI script that opens
the simulation file, resumes from the last state, runs ``solve`` and
optionally renders an animation.  The script imports quflow_tpu_torch and
steps with :class:`~quflow_tpu_torch.parallel.stepper.IsompTorch` on
``--device`` (default: the CUDA device).  It never picks the CPU by itself:
without a card and without ``--device cpu`` it raises, as
``config.device(None)`` does, where quflow_tpu's runfile probes the JAX
backend and falls back to the host integrator.
"""

from __future__ import annotations

import os

__all__ = ["create_runfile"]

_RUNFILE_TEMPLATE = '''\
#!/usr/bin/env python
"""Auto-generated quflow_tpu_torch runfile for {simname}."""
import argparse

parser = argparse.ArgumentParser(description="Run simulation {simname}")
parser.add_argument("-f", "--filename", default="{filename}")
parser.add_argument("-s", "--simulate", action="store_true", default={simulate})
parser.add_argument("-a", "--animate", action="store_true", default={animate})
parser.add_argument("--simtime", type=float, default=None)
parser.add_argument("--tol", type=float, default=None,
                    help="adaptive fixed-point tolerance (default: maxit "
                         "iterations a step)")
parser.add_argument("--compsum", action="store_true", default=False)
parser.add_argument("--maxit", type=int, default=10)
parser.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; without a "
                         "card pass --device cpu)")
args = parser.parse_args()

from quflow_tpu_torch.parallel.stepper import IsompTorch
from quflow_tpu_torch.sim import QuSimulation, solve

sim = QuSimulation(args.filename)

if args.simulate:
    kwargs = {{}}
    if args.simtime is not None:
        kwargs["simtime"] = args.simtime
        kwargs["steps"] = None
    kwargs["integrator"] = IsompTorch(maxit=args.maxit, compsum=args.compsum,
                                      tol=args.tol, device=args.device)
    with open("{progress_filename}", "w") as progress_file:
        solve(sim, progress_bar=True, progress_file=progress_file, **kwargs)

if args.animate:
    try:
        from quflow_tpu_torch import graphics
        graphics.create_animation(
            "{simname}.mp4", sim["fun"], progress_file="{anim_progress_filename}"
        )
    except Exception as exc:  # animation is best-effort on headless nodes
        print("Animation skipped:", exc)
'''


def create_runfile(sim, runfilename=None, simulate=True, animate=True):
    """Write a standalone runfile next to the simulation file; returns path."""
    filename = sim.filename if hasattr(sim, "filename") else str(sim)
    base = os.path.basename(filename).replace(".hdf5", "").replace(".h5", "")
    dirname = os.path.dirname(filename)
    if runfilename is None:
        runfilename = os.path.join(dirname, base + "_runfile.py")
    content = _RUNFILE_TEMPLATE.format(
        simname=base,
        filename=os.path.basename(filename),
        simulate=simulate,
        animate=animate,
        progress_filename=base + "_progress.txt",
        anim_progress_filename=base + "_anim_progress.txt",
    )
    with open(runfilename, "w") as f:
        f.write(content)
    os.chmod(runfilename, 0o755)
    return runfilename
