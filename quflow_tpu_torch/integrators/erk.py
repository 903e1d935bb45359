"""Classical explicit Runge-Kutta integrators (non-conservative references).

Counterpart of quflow_tpu/integrators/erk.py (reference
quflow/integrators/erk.py: euler :17-62, heun :65-112, rk4 :115-160) on the
vector field W' = (1/hbar)[P, W] (+ forcing).  Devices and hooks as in
integrators/isospectral.py: a tensor state stays on its device, a numpy
state goes to ``config.device(device)`` (the card by default) and is
overwritten with the result; ``dt`` is rounded to the state's real dtype.

quflow_tpu jits a ``lax.scan`` of one step over ``steps``.  Here one step
is the function of :func:`_step_fn`; on a CUDA device (outside
``config.eager()``) it is captured once as a CUDA graph over a static
state (parallel/capture.py) and the graph is replayed ``steps`` times a
call, the counterpart of that scan.  The graph is kept between calls of
the same configuration (method, dt, hooks, the state's shape, dtype and
device, the column solve), whatever ``steps``, in the bounded cache of
``isomp``'s loops (integrators/isospectral._LOOPS).  The default
Hamiltonian is one configuration: quflow_tpu keys its cache on a fresh
``partial`` a call, so each of its calls compiles again and its cache
grows a call.  Inside ``config.eager()`` and on the CPU the same step
function runs in a Python loop, so the two paths compute the same bits.
A stacked state (k, N, N) takes ``solve_poisson``'s default
``reduce='first'``: state 0's stream function, broadcast (an ``expand``
view), which a graph holds as it is.

A hook (``hamiltonian(W)``, ``forcing(P, W)``; neither takes time) is
captured with the step, so on the card it must be capturable: tensors
in, a tensor on the state's device out, no host read or copy
(parallel.capture.hook; a hook that breaks this raises at the first call,
naming ``config.eager()``, inside which it runs eagerly).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import config
from ..ops.geometry import bracket
from ..ops.laplacian import solve_poisson
from .isospectral import _capture_key, _fixed_point_loop, update_stats

__all__ = ["euler", "heun", "rk4", "explicit"]


def _step_fn(method, hamiltonian, forcing, h, h2, h6):
    """One step ``W -> W`` of ``method`` with the step ``h`` and its half
    ``h2`` and sixth ``h6`` (Python floats, rounded in the state's real
    dtype), calling the hooks through parallel.capture.hook."""
    from ..parallel import capture

    def f(W):
        P = capture.hook("hamiltonian", hamiltonian, W, W)
        F = bracket(P, W)
        if forcing is not None:
            F = F + capture.hook("forcing", forcing, W, P, W)
        return F

    if method == "euler":
        def step(W):
            return W + h * f(W)
    elif method == "heun":
        def step(W):
            F0 = f(W)
            F1 = f(W + h * F0)
            return W + h2 * (F0 + F1)
    else:  # rk4
        def step(W):
            K1 = f(W)
            K2 = f(W + h2 * K1)
            K3 = f(W + h2 * K2)
            K4 = f(W + h * K3)
            return W + h6 * (K1 + 2 * K2 + 2 * K3 + K4)
    return step


class _StepGraph:
    """``step`` captured once over a static copy of ``W``
    (``W_static <- step(W_static)``), replayed ``steps`` times a call."""

    def __init__(self, step, W):
        from ..parallel import capture

        self.W = capture.static_copy(W)
        self.graphs = capture.Graphs(W.device)

        def piece():
            self.W.copy_(step(self.W))

        (self.graph,) = self.graphs.capture(piece)

    def run(self, W, steps):
        """``steps`` steps from ``W``: a fresh tensor."""
        self.W.copy_(W)
        for _ in range(steps):
            self.graph.replay()
        return self.W.clone()

    def close(self):
        """Release the graph, its pool and the static state."""
        self.graph.graph.reset()
        self.graph = self.graphs = self.W = None


@torch.no_grad()
def _integrate(method, W, dt, steps, hamiltonian, forcing, stats, device):
    Wt = config.to_tensor(W, device)
    r = config.numpy_dtype(Wt.real.dtype).type
    h = r(dt)
    h2, h6 = float(h / r(2.0)), float(h / r(6.0))
    h = float(h)
    # the default Hamiltonian keys as None: one graph for every call
    key = _capture_key("erk", Wt, method, h, hamiltonian, forcing)
    if hamiltonian is None:
        hamiltonian = partial(solve_poisson, skewh=True)
    step = _step_fn(method, hamiltonian, forcing, h, h2, h6)

    if key is not None:
        with _fixed_point_loop(key, lambda: _StepGraph(step, Wt)) as graph:
            Wt = graph.run(Wt, steps)
    else:
        for _ in range(steps):
            Wt = step(Wt)
    if stats is not None:
        update_stats(stats, steps=steps)
    if isinstance(W, np.ndarray):
        np.copyto(W, Wt.cpu().numpy())
        return W
    return Wt


def euler(W, dt, steps=100, hamiltonian=None, forcing=None, stats=None, *,
          device=None, **kwargs):
    """Explicit Euler (first order)."""
    return _integrate("euler", W, dt, steps, hamiltonian, forcing, stats,
                      device)


def heun(W, dt, steps=100, hamiltonian=None, forcing=None, stats=None, *,
         device=None, **kwargs):
    """Heun's method (second order)."""
    return _integrate("heun", W, dt, steps, hamiltonian, forcing, stats,
                      device)


def rk4(W, dt, steps=100, hamiltonian=None, forcing=None, stats=None, *,
        device=None, **kwargs):
    """Classical fourth-order Runge-Kutta."""
    return _integrate("rk4", W, dt, steps, hamiltonian, forcing, stats,
                      device)


explicit = heun
