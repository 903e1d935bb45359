"""Declarative callable registry for simulation persistence.

Counterpart of quflow_tpu/sim/registry.py: persisted callables are stored
*by name* and resolved through this registry; arbitrary code never runs on
load.  The names quflow_tpu registers for the modules this port holds
are registered (the solves and ``laplace``; ``isomp``, ``isomp_fixedpoint``,
``isomp_quasinewton``, ``isomp_simple``; ``euler``, ``heun``, ``rk4``;
``magmp``, ``magmp_fixedpoint``, ``solve_mhd``; the loggers and norms), and
the port's own integrators ``isomp_torch`` and ``magmp_torch``.
"""

from __future__ import annotations

import warnings

_REGISTRY: dict = {}

_RAISE = object()  # sentinel: resolve() raises on unknown names by default


def register(name, fn=None):
    """Register a callable for by-name persistence.  Usable as decorator."""
    if fn is None:
        def deco(f):
            _REGISTRY[name] = f
            return f

        return deco
    _REGISTRY[name] = fn
    return fn


def resolve(name, default=_RAISE, warn=True):
    """Name -> callable.  Unknown names raise ``KeyError`` with a
    ``register()`` hint; callers that can degrade gracefully (optional
    loggers) pass an explicit ``default``."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if default is not _RAISE:
        if not warn:
            return default
        warnings.warn(
            f"Callable '{name}' is not registered in quflow_tpu_torch.sim."
            f"registry; using default {default!r}.  Register it with "
            f"quflow_tpu_torch.sim.registry.register({name!r}, fn) before "
            f"resuming.")
        return default
    raise KeyError(
        f"Callable '{name}' is not registered in quflow_tpu_torch.sim."
        f"registry.  A simulation persisted it by name; register the "
        f"implementation before resuming:  from quflow_tpu_torch.sim import "
        f"registry; registry.register({name!r}, your_function)")


def name_of(fn):
    """Callable -> registered name (or its __name__ if registered that way)."""
    for k, v in _REGISTRY.items():
        if v is fn:
            return k
    nm = getattr(fn, "__name__", None)
    if nm in _REGISTRY:
        return nm
    return None


_WARM: dict = {}  # (integrator class, maxit, fast, device) -> warm instance


def _warm_call(cls, W, dt, steps, maxit, fast, device, kwargs):
    """Call the warm ``cls`` instance for (maxit, fast, device): complex64
    when ``fast`` else complex128."""
    from .. import config

    key = (cls, int(maxit), bool(fast), config.device(device))
    if key not in _WARM:
        import numpy as np

        _WARM[key] = cls(maxit=key[1],
                         dtype=np.complex64 if fast else np.complex128,
                         device=key[3])
    return _WARM[key](W, dt, steps=steps, **kwargs)


def isomp_torch(W, dt, steps=100, maxit=5, fast=True, time=None,
                verbatim=None, device=None, **kwargs):
    """Registrable form of :class:`parallel.stepper.IsompTorch`: one warm
    instance per (maxit, fast, device), complex64 when ``fast`` else
    complex128, on ``device`` (default: the CUDA device; ``solve(...,
    device="cpu")`` hands the CPU through).  ``time`` and ``verbatim``
    (sent by solve and by runfiles) do not change a fixed-iteration step.
    Any other kwarg - ``tol``, ``minit``, ``compsum`` included - raises
    TypeError instead of being dropped."""
    from ..parallel.stepper import IsompTorch

    return _warm_call(IsompTorch, W, dt, steps, maxit, fast, device, kwargs)


def magmp_torch(W, dt, steps=100, maxit=5, fast=True, time=None,
                verbatim=None, device=None, **kwargs):
    """Registrable form of :class:`parallel.stepper.MagmpTorch`, the MHD
    twin of :func:`isomp_torch`, with the same contract: one warm instance
    per (maxit, fast, device), and TypeError on ``tol``, ``minit``,
    ``compsum`` or any other kwarg instead of dropping it."""
    from ..parallel.stepper import MagmpTorch

    return _warm_call(MagmpTorch, W, dt, steps, maxit, fast, device, kwargs)


def _register_defaults():
    from .. import physics
    from ..integrators import erk, mhd
    from ..integrators import isospectral as iso
    from ..ops import geometry
    from ..ops import laplacian as lap

    _REGISTRY.setdefault("isomp_torch", isomp_torch)
    _REGISTRY.setdefault("magmp_torch", magmp_torch)
    for mod, names in (
        (lap, ["solve_poisson", "solve_heat", "solve_helmholtz", "solve_viscdamp",
               "solve_globalqg", "laplace"]),
        (iso, ["isomp", "isomp_fixedpoint", "isomp_quasinewton", "isomp_simple"]),
        (erk, ["euler", "heun", "rk4"]),
        (mhd, ["magmp", "magmp_fixedpoint", "solve_mhd"]),
        (physics, ["energy_euler", "enstrophy", "norm_H1", "norm_Hm1"]),
        (geometry, ["norm_L2", "norm_Linf", "norm_L1", "integral"]),
    ):
        for nm in names:
            _REGISTRY.setdefault(nm, getattr(mod, nm))


_register_defaults()
