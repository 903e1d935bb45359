"""Top-level simulation driver.

Functional parity with reference quflow/simulation.py:584-803 ``solve``:
resolves dt/stepsize, exactly one of steps/simtime/endtime, output cadence
(steps_out/dt_out, default 100), runs the integrator in chunks and fires
callbacks with (delta_time, delta_steps, **stats).  Passing a QuSimulation
restores W/time/all stored args from the file and appends the sim as a
callback - the restart mechanism (bit-exact: proven by
tests/test_simulation.py restart-equality test).

A copy of quflow_tpu/sim/solve.py: the default integrator is ``isomp``
(integrators/isospectral.py).  Keywords it does not take itself, ``device=``
among them, pass through to the integrator.
"""

from __future__ import annotations

import inspect
import warnings

from ..integrators.isospectral import isomp
from ..ops.geometry import hbar
from .simulation import QuSimulation

__all__ = ["solve", "in_notebook"]


def in_notebook():
    """True when running under a Jupyter kernel (reference
    simulation.py:24-33); drives the tqdm frontend choice."""
    try:
        from IPython import get_ipython

        ip = get_ipython()
        return ip is not None and "IPKernelApp" in ip.config
    except ImportError:
        return False


def solve(
    W,
    dt=None,
    stepsize=None,
    steps=None,
    simtime=None,
    endtime=None,
    steps_out=None,
    dt_out=None,
    integrator=None,
    callback=None,
    callback_kwargs=None,
    integrator_callback=None,
    progress_bar=True,
    progress_file=None,
    **kwargs,
):
    """Run a simulation; see the reference docstring for the full parameter
    contract.  ``W`` may be a state matrix or a QuSimulation to resume."""
    time = kwargs.pop("time", 0.0)

    if isinstance(W, QuSimulation):
        sim = W
        W = sim["mat", -1]
        time = float(sim["time", -1])
        if callback is None:
            callback = sim
        elif isinstance(callback, tuple):
            callback += (sim,)
        else:
            callback = (callback, sim)
        overridable = {
            "dt": dt, "stepsize": stepsize, "steps": steps, "simtime": simtime,
            "endtime": endtime, "steps_out": steps_out, "dt_out": dt_out,
            "integrator": integrator, "callback_kwargs": callback_kwargs,
        }
        for name, value in sim.args():
            if name in ("inner_steps",):
                name = "steps_out"
            if name in ("inner_time",):
                name = "dt_out"
            if name in overridable:
                if overridable[name] is None:
                    overridable[name] = value
            elif name in ("integrator_callback", "callback"):
                if integrator_callback is None:
                    integrator_callback = value
            elif name in ("progress_bar", "progress_file"):
                pass
            else:
                kwargs.setdefault(name, value)
        dt = overridable["dt"]
        stepsize = overridable["stepsize"]
        steps = overridable["steps"]
        simtime = overridable["simtime"]
        endtime = overridable["endtime"]
        steps_out = overridable["steps_out"]
        dt_out = overridable["dt_out"]
        integrator = overridable["integrator"]
        callback_kwargs = overridable["callback_kwargs"]

    N = W.shape[-1]

    if dt is None:
        if stepsize is None:
            raise ValueError("Either `dt` or `stepsize` must be specified.")
        dt = stepsize * hbar(N)
    dt = float(dt)

    if integrator is None:
        integrator = isomp

    integrator_kwargs = dict(kwargs)
    integrator_kwargs["time"] = time
    if "hamiltonian" not in integrator_kwargs:
        integrator_kwargs["hamiltonian"] = None  # integrator default (solve_poisson)
    if integrator_kwargs["hamiltonian"] is None:
        integrator_kwargs.pop("hamiltonian")
    if "stats" in inspect.getfullargspec(integrator).args:
        integrator_kwargs["stats"] = {"iterations": 0.0}
    if integrator_callback is not None:
        integrator_kwargs["callback"] = integrator_callback

    if sum(x is not None for x in (steps, simtime, endtime)) != 1:
        warnings.warn(
            "One, and only one, of `steps`, `simtime`, or `endtime` should be "
            "specified."
        )
    if endtime is not None:
        if endtime < time:
            raise ValueError(
                f"Specified `endtime`={endtime} is smaller than current "
                f"`time`={time}."
            )
        simtime = endtime - time
    if simtime is not None:
        steps = round(simtime / abs(dt))
    steps = int(steps)

    if callback is not None and not isinstance(callback, tuple):
        callback = (callback,)
    if callback_kwargs is None:
        callback_kwargs = {}

    if steps_out is None:
        steps_out = round(dt_out / abs(dt)) if dt_out is not None else 100
    steps_out = int(min(steps_out, steps)) if steps else int(steps_out)

    pbar = None
    if progress_bar:
        try:
            from tqdm.auto import tqdm

            if progress_file is None:
                if not integrator_kwargs.get("verbatim", False):
                    pbar = tqdm(total=steps, unit=" steps")
            else:
                from tqdm import tqdm as tqdm_plain

                pbar = tqdm_plain(
                    total=steps, unit=" steps", file=progress_file,
                    ascii=True, mininterval=10.0,
                )
        except ModuleNotFoundError:
            pbar = None

    for k in range(0, steps, steps_out):
        no_steps = min(steps_out, steps - k)
        W = integrator(W, dt, steps=no_steps, **integrator_kwargs)
        delta_time = no_steps * dt
        integrator_kwargs["time"] += delta_time
        if pbar is not None:
            pbar.update(no_steps)
        if callback is not None:
            for cfun in callback:
                if "stats" in integrator_kwargs:
                    callback_kwargs.update(integrator_kwargs["stats"])
                cfun(W, delta_time=delta_time, delta_steps=no_steps, **callback_kwargs)

    if pbar is not None:
        pbar.close()
    return W
