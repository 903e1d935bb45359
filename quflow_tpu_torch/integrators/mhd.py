"""Magnetic (MHD) isospectral midpoint integrator.

Counterpart of quflow_tpu/integrators/mhd.py (reference
quflow/integrators/mhd.py: ``solve_mhd`` :10-18, ``magmp_fixedpoint``
:235-456): two-component state (2, N, N) with state[0] = W (vorticity) and
state[1] = Theta (magnetic flux function), evolving W' = [P, W] +
[B, Theta], Theta' = [P, Theta] with P = Delta^-1 W and B = Delta Theta.
Run like integrators/isospectral.py, with the same loop contract:
quflow_tpu's exit rule, on a card one graph launch a step with the exit on
the card and one host read a call (an iteration in the host loop of the
CPU and ``config.eager()``), the devices and hooks of isomp.  Each
iteration solves W once (one column-kernel launch); the Laplacian of
Theta is elementwise.
"""

from __future__ import annotations

import numpy as np

from .. import config, tracing
from ..ops.geometry import hbar
from ..ops.laplacian import laplace, solve_poisson
from .isospectral import (
    _CapturedLoop,
    _Loop,
    _auto_tol,
    _check_iterations,
    _capture_key,
    _fixed_point_loop,
    _like,
    _probe_autonomous,
    _returned,
)

__all__ = ["solve_mhd", "magmp_fixedpoint", "magmp"]


def solve_mhd(state, *, device=None):
    """Hamiltonian of the quantized MHD system: (P, B) = (Delta^-1 W,
    Delta Theta)."""
    W = state[..., 0, :, :]
    Theta = state[..., 1, :, :]
    P = solve_poisson(W, skewh=True, device=device)
    B = laplace(Theta, skewh=True, device=device)
    return P, B


def _iteration(W, dW, ham, force, vareps, dt_half):
    """One fixed-point iteration from ``dW``: (dW_new, PWc, BTc, FW)."""
    Whalf = W + dW
    Thetahalf = Whalf[1]
    Phalf, Bhalf = ham(Whalf)
    Phalf = Phalf * vareps
    Bhalf = Bhalf * vareps
    PWc = Phalf @ Whalf  # broadcasts over the 2 components
    BTc = Bhalf @ Thetahalf
    dW_new = PWc @ Phalf
    BTP = BTc @ Phalf
    PWc = PWc - PWc.mH
    BTc = BTc - BTc.mH
    dW_new = dW_new + PWc
    dW_new[0] += BTP - BTP.mH + BTc
    FW = None
    if force is not None:
        FW = force(Phalf / vareps, Whalf) * dt_half
        dW_new = dW_new + FW
    return dW_new, PWc, BTc, FW


def magmp_fixedpoint(
    W,
    dt,
    steps=100,
    hamiltonian=solve_mhd,
    time=None,
    forcing=None,
    stats=None,
    callback=None,
    tol="auto",
    maxit=10,
    minit=1,
    verbatim=False,
    reinitialize=False,
    *,
    device=None,
):
    """Magnetic midpoint method on the (2, N, N) state (W, Theta).

    ``stats`` gets 'iterations' and 'maxit' (the fraction of steps that hit
    the cap) a step, and 'tol' when it is 'auto'; ``callback(W_prev,
    W_new - W_prev)`` runs each step, with numpy for a numpy state.

    On a CUDA device (outside ``config.eager()``), each step is one
    launch of a CUDA graph, ``hamiltonian`` and ``forcing`` in it, the
    fixed point exiting on the card, kept for the next call with the same
    hooks, as in ``isomp_fixedpoint``, whose rule for capturable hooks
    holds here."""
    from ..parallel import capture

    with tracing.span("quflow.integrator.prepare"):
        _check_iterations(minit, maxit)
        Wt = config.to_tensor(W, device)
        N = Wt.shape[-1]
        hb = hbar(N)
        rd = config.numpy_dtype(Wt.real.dtype)

        timed = time is not None
        autonomous = _probe_autonomous(hamiltonian, (Wt,), time)
        autonomous_force = (forcing is None
                            or _probe_autonomous(forcing, (Wt, Wt), time))

        if tol == "auto" or (np.isscalar(tol) and tol < 0):
            tol = _auto_tol(W, Wt, dt, hb, sqrt_eps=True)
            if stats is not None:
                stats["tol"] = tol

        r = rd.type
        vareps = float(r(dt / (2.0 * hb)))
        tol_r = float(r(tol))
        dt_r = r(dt)
        dt_half = dt_r / r(2)
        t = r(0.0 if time is None else time)

        ham_timed = timed and not autonomous
        force_timed = timed and not autonomous_force

        def iteration(Wh, dW, time):
            def ham(Whalf):
                kw = {"time": time} if ham_timed else {}
                out = capture.call("hamiltonian", hamiltonian, Whalf, **kw)
                return tuple(_like(a, Whalf, "hamiltonian", hamiltonian)
                             for a in out)

            force = None
            if forcing is not None:
                def force(P, Whalf):
                    kw = {"time": time} if force_timed else {}
                    return capture.hook("forcing", forcing, Whalf, P, Whalf,
                                        **kw)

            return _iteration(Wh, dW, ham, force, vareps, float(dt_half))

        def update(W, rest, csum):
            """W after the step's update from the last iteration's rest."""
            PWc, BTc, FW = rest
            W_new = W + 2.0 * PWc
            W_new[0] += 2.0 * BTc
            if forcing is not None:
                W_new = W_new + 2.0 * FW
            return W_new, csum

        def host(A):
            return config.like_input(A, W)

        timed_hooks = ham_timed or force_timed
        key = _capture_key("magmp", Wt, vareps, float(dt_half), hamiltonian,
                           forcing, ham_timed, force_timed, bool(reinitialize))
    if key is not None:
        def on_step(W_prev, W_new, rest):
            callback(host(W_prev), host(W_new - W_prev))

        def make():
            return _CapturedLoop(iteration, update, Wt,
                                 reinitialize=reinitialize,
                                 times=(dt_half, dt_r) if timed_hooks
                                 else None)

        with _fixed_point_loop(key, make) as loop:
            Wt, total_iters, total_maxit = loop.run(
                Wt, steps, tol_r, maxit, minit, t,
                None if callback is None else on_step)
    else:
        loop = _Loop(iteration, Wt)
        total_iters = total_maxit = 0
        with tracing.span("quflow.runner.launch", launches=0, steps=steps):
            for _ in range(steps):
                if reinitialize:
                    loop.reset()
                rest, i, hit = loop(Wt, tol_r, maxit, minit,
                                    float(t + dt_half) if timed_hooks
                                    else None)
                W_new, _ = update(Wt, rest, None)
                if timed:
                    t = t + dt_r
                if callback is not None:
                    callback(host(Wt), host(W_new - Wt))
                Wt = W_new
                total_iters += i
                total_maxit += int(hit)

    with tracing.span("quflow.integrator.finish"):
        if verbatim:
            print("Average number of iterations per step: {:.2f}".format(
                total_iters / steps))
        if stats is not None:
            stats["iterations"] = total_iters / steps
            stats["maxit"] = total_maxit / steps
        return _returned(W, Wt)


magmp = magmp_fixedpoint
