"""Faults planted in the timed path, underneath the harness: each wraps
the integrator that ``solve`` calls and breaks what it hands back, or the
exit rule it runs, or (``local_max``) the max of the residual over the
ranks of a dp mesh.  The output check has to come out not correct under
each that a cell can have (tests/test_portbench_control.py on the CPU;
``calibrate.py --fault`` reads them on the card).  The benchmark's own
runs never plant one."""

from __future__ import annotations

import copy

__all__ = ["FAULTS", "EXIT_RULE", "applies", "wrap"]


def _wrap(change_kwargs=None, change_out=None, short=0):
    def fault(integrate):
        def call(W, dt, steps=100, stats=None, time=None, **kw):
            if change_kwargs is not None:
                kw = change_kwargs(dict(kw))
            out = integrate(W, dt, steps=steps - short, stats=stats,
                            time=time, **kw)
            return out if change_out is None else change_out(W, out)
        return call
    return fault


def _unchanged(W, out):
    return W.clone()


def _half_batch(W, out):
    half = out.shape[0] // 2
    out[half:] = W[half:]
    return out


def _altered(W, out):
    out[..., 1, 2] += 1e-2 * out.abs().amax()
    return out


def _run_to_maxit(kw):
    kw["minit"] = kw.get("maxit", 10)
    return kw


def _stop_at_minit(kw):
    kw["maxit"] = kw.get("minit", 1)
    return kw


def _tol_ignored(kw):
    kw["tol"] = 0.0  # only a stall or maxit ends a step
    return kw


def _rule(change):
    """An exit rule's fault: ``change`` of solve's keywords, or of the
    rule an integrator holds itself (a mesh mix's), before its first
    call builds its runners."""
    def fault(integrate):
        if not hasattr(integrate, "minit"):
            return _wrap(change_kwargs=change)(integrate)
        rule = change({"tol": integrate.tol, "maxit": integrate.maxit,
                       "minit": integrate.minit})
        integrate.tol, integrate.maxit, integrate.minit = (
            rule["tol"], rule["maxit"], rule["minit"])
        return integrate
    return fault


def _local_max(integrate):
    """Each rank's residual taken over its own members alone: the
    integrator's mesh with its max over the ranks (the all_reduce of the
    residual's key, on the card captured inside the WHILE node) left
    out, before its first call builds its runners."""
    mesh = copy.copy(integrate.mesh)
    mesh.max = lambda value, device: float(value)
    mesh.max_ = lambda key: key
    integrate.mesh = mesh
    return integrate


FAULTS = {
    "unchanged": _wrap(change_out=_unchanged),
    "half_batch": _wrap(change_out=_half_batch),
    "altered": _wrap(change_out=_altered),
    "one_step_short": _wrap(short=1),
    "run_to_maxit": _rule(_run_to_maxit),
    "stop_at_minit": _rule(_stop_at_minit),
    "tol_ignored": _rule(_tol_ignored),
    "local_max": _local_max,
}

#: the faults of an exit rule, which only a mix with one (``exit_rule``)
#: can have
EXIT_RULE = ("run_to_maxit", "stop_at_minit", "tol_ignored")


def applies(fault, traffic):
    """Whether a cell under the mix ``traffic`` can have ``fault``: half
    of a batch needs an ensemble, an exit rule's fault an exit rule, the
    max over the ranks a mesh and an exit rule."""
    if fault == "half_batch":
        return bool(traffic.get("batched"))
    if fault == "local_max":
        return "mesh" in traffic and "exit_rule" in traffic
    if fault in EXIT_RULE:
        return "exit_rule" in traffic
    return True


def wrap(name):
    """The ``wrap`` of harness.measure that plants the fault ``name``
    under the timed path (None: none)."""
    if name is None:
        return None

    def plant(integrator, program):
        return FAULTS[name](program.default_integrator())
    return plant
