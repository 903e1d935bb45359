"""Declarative callable registry for simulation persistence.

Counterpart of quflow_tpu/sim/registry.py: persisted callables are stored
*by name* and resolved through this registry; arbitrary code never runs on
load.  Only the names this port implements are registered: the loggers
``energy_euler``, ``enstrophy`` and ``norm_L2``, and the integrators
``isomp_torch`` and ``magmp_torch``.
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
    from ..ops import geometry

    _REGISTRY.setdefault("isomp_torch", isomp_torch)
    _REGISTRY.setdefault("magmp_torch", magmp_torch)
    _REGISTRY.setdefault("energy_euler", physics.energy_euler)
    _REGISTRY.setdefault("enstrophy", physics.enstrophy)
    _REGISTRY.setdefault("norm_L2", geometry.norm_L2)


_register_defaults()
