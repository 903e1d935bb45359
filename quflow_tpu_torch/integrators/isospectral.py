"""Isospectral midpoint integrators (Modin-Viviani, JFM 884:A22, 2020).

Counterpart of quflow_tpu/integrators/isospectral.py (reference
quflow/integrators/isospectral.py: ``isomp_fixedpoint`` :338-613,
``isomp_quasinewton`` :155-255, ``isomp_simple`` :258-335,
``estimate_stepsize`` :121-148), on torch tensors.  The fixed-point loop
keeps quflow_tpu's exit rule,

    stop when i >= minit and (rn <= tol or rn >= rn_old), or at i = maxit,

with rn the inf-norm of the change of dW.  On a CUDA device each step is
one launch of a CUDA graph (parallel/capture.Loop), the counterpart of
quflow_tpu's jitted scan with a device ``lax.while_loop`` inside: the
Strang half-step, ``reinitialize``'s reset and the midpoint time, then a
WHILE node running the iteration (its hooks with it), each pass ended by
the kernel ``loop_pass`` (ops/cuda_graph_loop.py: the residual, dW
written back and the rule on the card), then the update, forcing, time
and the second half-step.  A call launches
its steps and reads its iteration sums once; the graphs are kept between
calls of the same configuration (the last few), as quflow_tpu keeps one
jitted program for each set of hooks.  Inside ``config.eager()`` and on
the CPU the loop runs on the host, every kernel issued from Python and
the residual (``loop_pass``'s, its rule off: ops/cuda_graph_loop.residual_)
read once an iteration (one ``.item()``).  Either way the
counts and results are the same.  The update is the last iteration's
2 (PW - (PW)^H), Kahan-compensated with ``compsum``.
parallel.stepper.IsompTorch is the other integrator: a fixed iteration
count with no sync, and other results.

A tensor state is stepped on its own device and a tensor comes back; a
numpy state goes to ``config.device(device)`` (the card by default; pass
``device="cpu"`` without one) and is overwritten with the result, which
is returned.  The hooks ``hamiltonian``, ``forcing`` and
``strang_splitting`` receive tensors on the state's device.  On the CPU
they may return numpy or tensors and ``time`` reaches them as a float; on
a CUDA device, where they are captured, they return tensors there, read
and copy nothing on the host, and ``time`` reaches them as a 0-d tensor
of the working precision on the card (parallel/capture.py; a hook that
breaks this raises, and ``config.eager()`` runs it eagerly).  ``vareps``,
``tol`` and ``dt`` are rounded to the state's real dtype, as quflow_tpu
rounds them, so complex64 stays complex64.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from functools import partial

import numpy as np
import torch

from .. import config, tracing
from ..ops.cuda_graph_loop import ITERATIONS, residual_
from ..ops.geometry import hbar, norm_Linf
from ..ops.laplacian import solve_poisson

__all__ = [
    "isomp_fixedpoint",
    "isomp",
    "isomp_quasinewton",
    "isomp_simple",
    "commutator",
    "commutator_skewherm",
    "commutator_generic",
    "select_skewherm",
    "estimate_stepsize",
    "update_stats",
    "conj_subtract_",
    "project_skewherm",
]


def _conj_t(A):
    if isinstance(A, torch.Tensor):
        return A.mH
    return np.conj(np.swapaxes(A, -1, -2))


def commutator_generic(W, P):
    return W @ P - P @ W


def commutator_skewherm(W, P):
    VF = W @ P
    return VF - _conj_t(VF)


commutator = commutator_skewherm


def conj_subtract_(A, out=None):
    """Host helper: ``out = A - A^dagger`` (in place into ``out``;
    reference integrators/isospectral.py:66-81)."""
    A = np.asarray(A)
    if out is None:
        out = np.empty_like(A)
    np.subtract(A, np.conj(np.swapaxes(A, -1, -2)), out=out)
    return out


def project_skewherm(W):
    """Host helper: project onto skew-Hermitian matrices in place,
    W <- (W - W^dagger)/2 (reference integrators/isospectral.py:61-63)."""
    W /= 2.0
    W -= np.conj(np.swapaxes(W, -1, -2))
    return W


def select_skewherm(flag):
    """Reference-compatible mode switch (reference isospectral.py:97-118):
    sets the default commutator and the laplacian-solver default.  Prefer the
    explicit ``skewh`` keyword in new code."""
    global commutator
    commutator = commutator_skewherm if flag else commutator_generic
    from ..ops.laplacian import select_skewherm as _lap_select

    return _lap_select(flag)


def update_stats(stats: dict, **kwargs):
    for arg, val in kwargs.items():
        if arg in stats and np.isscalar(val):
            stats[arg] += val
        else:
            stats[arg] = val


def estimate_stepsize(W, P=None, safety_factor=0.1, *, device=None):
    """Dimension-free stepsize estimate safety*pi/lambda_max(P)."""
    if P is None:
        P = solve_poisson(W, device=device)
    lambda_max = float(norm_Linf(P))
    return safety_factor * np.pi / lambda_max


def _like(x, W, kind="hook", fn=None):
    """A hook's result as a tensor of W's dtype on W's device, held to the
    capture's rule while a loop warms up or is captured
    (parallel.capture.like)."""
    from ..parallel import capture

    return capture.like(x, W, kind, fn)


def _probe_autonomous(fn, args, time):
    """Mirror the reference's TypeError probing (isospectral.py:404-423),
    with ``time`` as the hook would receive it on the state's device
    (parallel.capture.device_time)."""
    from ..parallel import capture

    if time is None:
        return True
    try:
        fn(*args, time=capture.device_time(float(time), args[0]))
    except TypeError:
        return True
    return False


def _check_iterations(minit, maxit):
    if minit < 1:
        raise ValueError("minit must be at least 1.")
    if maxit < minit:
        raise ValueError("maxit must be at least minit.")


def _auto_tol(W, Wt, dt, hb, sqrt_eps):
    """quflow_tpu's 'auto' tolerance: eps * dt/hbar * ||W_0||_inf, with
    eps the machine epsilon of the state (its square root with
    ``sqrt_eps``) and W_0 the first of stacked states."""
    eps = np.finfo(config.numpy_dtype(Wt.dtype)).eps
    if sqrt_eps:
        eps = np.sqrt(eps)
    if isinstance(W, torch.Tensor):
        W0 = W[(0,) * (W.ndim - 2)]
        with tracing.host_read("tol"):
            norm = torch.linalg.matrix_norm(W0, ord=float("inf")).item()
    else:
        Wn = np.asarray(W)
        norm = np.linalg.norm(Wn[(0,) * (Wn.ndim - 2)], np.inf)
    return float(eps * dt / hb * norm)


def _iteration(W, dW, ham, force, skewh, vareps, dt_half):
    """One fixed-point iteration from ``dW``: (dW_new, PWc, FW)."""
    Whalf = W + dW
    Phalf = ham(Whalf) * vareps
    PW = Phalf @ Whalf
    dW_new = PW @ Phalf
    if skewh:
        PWc = PW - PW.mH
    else:
        PWc = PW - Whalf @ Phalf
    dW_new = dW_new + PWc
    FW = None
    if force is not None:
        FW = force(Phalf / vareps, Whalf) * dt_half
        dW_new = dW_new + FW
    return dW_new, PWc, FW


def _read(x):
    """The tensor ``x`` on the host (``tolist``: a 0-d residual as a Python
    float): the host sync of a run, once an iteration in the host loop,
    once a call (the stats) in the device loop.  One ``quflow.host_read``
    (tracing.py): of a residual where ``x`` is 0-d, else of a device
    loop's words, whose iteration sum the span notes."""
    counts = x.dim() > 0
    with tracing.host_read("counts" if counts else "residual") as span:
        out = x.tolist()
        if counts:
            span.set(iterations=out[ITERATIONS])
    return out


def _converge(iteration, tol, maxit, minit, reduce_max=None):
    """quflow_tpu's exit rule (quflow_tpu/parallel/stepper.py:773-807)
    over ``iteration()``, which runs one iteration and returns its residual
    as a host float: stop when i >= minit and (rn <= tol or rn >= rn_old),
    or at i = maxit; under a mesh rn is the max over its ranks
    (``reduce_max``).  Returns (iterations, whether the cap ended the
    loop).  The steppers of parallel/stepper.py exit by it too."""
    i, rn, rn_old = 0, np.inf, np.inf
    while i < maxit and not (i >= minit and (rn <= tol or rn >= rn_old)):
        rn_new = iteration()
        if reduce_max is not None:
            rn_new = reduce_max(rn_new)
        rn_old, rn = rn, rn_new
        i += 1
    return i, i >= maxit and not (rn <= tol or rn >= rn_old)


class _Loop:
    """The fixed-point loop of every step of a run, eager:
    ``iteration(W, dW, time) -> (dW_new, *rest)`` from the warm start
    :attr:`dW`, which the loop keeps between steps, at the midpoint time
    ``time`` of a call (a float, or None where no hook reads it) as
    parallel.capture.device_time gives it.  A call returns (the last
    iteration's
    rest, iterations, whether the cap ended the loop).  :meth:`strang`
    is the run's Strang half-step ``strang(S) -> S``."""

    def __init__(self, iteration, W, strang=None):
        self.iteration, self.strang = iteration, strang
        self.dW = torch.zeros_like(W, memory_format=torch.contiguous_format)

    def __call__(self, W, tol, maxit, minit, time=None):
        from ..parallel import capture

        rest = []
        if time is not None:
            time = capture.device_time(time, W)

        def once():
            dW_new, *rest[:] = self.iteration(W, self.dW, time)
            rn = _read(residual_(dW_new, self.dW))
            self.dW = dW_new
            return rn

        return (rest, *_converge(once, tol, maxit, minit))

    def reset(self):
        self.dW = torch.zeros_like(self.dW,
                                   memory_format=torch.contiguous_format)


class _CapturedLoop:
    """The steps of a run on a CUDA device, one launch each: a
    parallel.capture.Loop over static W, dW and csum (and, where a hook
    reads time, static 0-d times), the counterpart of quflow_tpu's jitted
    scan over the steps with a ``lax.while_loop`` inside.  Its head is the
    Strang half-step ``strang``, ``reinitialize``'s reset of dW and the
    midpoint time; the fixed point ``iteration(W, dW, time)`` runs in the
    composite's WHILE node; its tail is ``update(W, rest, csum) -> (W,
    csum)`` from the last iteration's rest, the second Strang half-step
    and the advance of time (``times`` = (dt/2, dt) in the working
    precision, or None where no hook reads time).  The host reads the
    call's iteration sums once, after its launches."""

    def __init__(self, iteration, update, W, strang=None,
                 reinitialize=False, times=None):
        from ..parallel import capture

        self.W = capture.static_copy(W)
        self.csum = torch.zeros_like(W)
        dW = torch.zeros_like(self.W)  # contiguous, as loop_pass reads it
        self.graphs = capture.Graphs(W.device)
        self.t = self.thalf = None
        if times is not None:
            half, dt = times
            self.t, self.thalf = (torch.zeros((), dtype=W.real.dtype,
                                              device=W.device)
                                  for _ in range(2))

        def head():
            if strang is not None:
                self.W.copy_(strang(self.W))
            if reinitialize:
                dW.zero_()
            if times is not None:
                self.thalf.copy_(self.t + half)

        def tail(rest):
            Wn, cn = update(self.W, rest, self.csum)
            if strang is not None:
                Wn = strang(Wn)
            self.W.copy_(Wn)
            if cn is not self.csum:
                self.csum.copy_(cn)
            if times is not None:
                self.t.copy_(self.t + dt)

        has_head = strang is not None or reinitialize or times is not None
        self.loop = capture.Loop(
            self.graphs, lambda Wh, d: iteration(Wh, d, self.thalf), self.W,
            dW, tail, head if has_head else None)

    def run(self, W, steps, tol, maxit, minit, t=0.0, callback=None):
        """``steps`` steps from ``W`` (dW and csum from zero, time from
        ``t``): one launch a step, or with ``callback`` one launch and then
        ``callback(W_prev, W, rest)`` a step.  Returns (W, iterations, steps
        at the cap) over the run, the sums read once."""
        with tracing.span("quflow.runner.load"):
            self.W.copy_(W)
            self.loop.dW.zero_()
            self.csum.zero_()
            if self.t is not None:
                self.t.fill_(float(t))
            self.loop.start(tol, maxit, minit)
        with tracing.span("quflow.runner.launch", launches=steps,
                          steps=steps):
            if callback is None:
                self.loop.launch(steps)
            else:
                for _ in range(steps):
                    W_prev = self.W.clone()
                    self.loop.launch(1)
                    callback(W_prev, self.W.clone(), self.loop.rest)
        iterations, capped = self.loop.finish(lambda x: _read(x))
        with tracing.span("quflow.runner.result"):
            return self.W.clone(), iterations, capped

    def close(self):
        self.loop.close()


#: the captured loops of isomp and magmp (and the step graphs of the
#: Runge-Kutta integrators, integrators/erk.py) between their calls, by
#: the configuration their graph holds; each keeps a graph pool and its
#: static state on the card, so only the last few are kept, and an evicted
#: one is closed: its graphs are destroyed with it
_LOOPS = OrderedDict()
_LOOPS_KEPT = 4


@contextlib.contextmanager
def _fixed_point_loop(key, make):
    """The captured runner of ``key`` (a :class:`_CapturedLoop`, or
    integrators/erk's step graph), ``make()`` at the first run of that
    configuration (``key`` names all that its graphs hold: the
    state's shape, dtype and device, the scalars, the hooks and the column
    solve), kept for the next."""
    loop = _LOOPS.pop(key, None)  # a nested run of one key gets its own
    if loop is None:
        loop = make()
    try:
        yield loop
    finally:
        other = _LOOPS.pop(key, None)
        if other is not None and other is not loop:
            other.close()
        _LOOPS[key] = loop
        while len(_LOOPS) > _LOOPS_KEPT:
            _LOOPS.popitem(last=False)[1].close()


def _capture_key(name, W, *config_):
    """The key of a captured loop of ``name`` for the state ``W``, or None
    where the run stays eager (not a CUDA device, or config.eager())."""
    from ..ops.shear_solve import column_solver
    from ..parallel import capture

    if not capture.available(W.device):
        return None
    return (name, tuple(W.shape), W.dtype, W.device, *config_,
            column_solver())


def isomp_fixedpoint(
    W,
    dt,
    steps=100,
    hamiltonian=None,
    time=None,
    forcing=None,
    strang_splitting=None,
    stats=None,
    callback=None,
    tol="auto",
    maxit=10,
    minit=1,
    verbatim=False,
    compsum=False,
    reinitialize=False,
    skewh=True,
    *,
    device=None,
):
    """Isospectral midpoint method with fixed-point iterations.

    Same contract as quflow_tpu's isomp_fixedpoint and the reference's
    (tolerance rule, stall exit, warm-started dW, final update
    W += 2(PW - (PW)^H) from the last iteration, optional forcing / Strang
    splitting / Kahan summation / per-step ``callback(W_prev, upd)`` and
    ``stats``: 'iterations' and 'number_of_maxit' a step, 'tol_auto').
    The callback gets numpy for a numpy state, tensors for a tensor (never
    a buffer that a later step overwrites).

    On a CUDA device (outside ``config.eager()``), each step is one
    launch of a CUDA graph (parallel/capture.Loop), its ``hamiltonian``,
    ``forcing`` and callable ``strang_splitting`` (with the concrete h =
    dt/2 as quflow_tpu passes it) in it, captured at the first call of a
    configuration; the fixed point exits on the card, and the call reads
    its iteration sums once, after its launches (with a ``callback``, the
    callback's own copies come after each launch).  The hooks must then
    be capturable, as quflow_tpu requires them "jax-traceable" (tensors
    in, a tensor on the state's device out, no host read or copy; ``time``
    a 0-d tensor on the card); their Python runs only when a configuration
    is first captured.  The graphs are kept for the next call with the
    same hooks (the last few).  Iteration counts and results are the
    eager loop's.
    """
    from ..parallel import capture

    with tracing.span("quflow.integrator.prepare"):
        _check_iterations(minit, maxit)
        Wt = config.to_tensor(W, device)
        hooks = (hamiltonian, forcing, strang_splitting)
        if hamiltonian is None:
            hamiltonian = partial(solve_poisson, skewh=skewh)

        N = Wt.shape[-1]
        hb = hbar(N)
        rd = config.numpy_dtype(Wt.real.dtype)

        timed = time is not None
        autonomous = _probe_autonomous(hamiltonian, (Wt,), time)
        autonomous_force = (forcing is None
                            or _probe_autonomous(forcing, (Wt, Wt), time))

        if tol == "auto" or (np.isscalar(tol) and tol < 0):
            tol = _auto_tol(W, Wt, dt, hb, sqrt_eps=not compsum)
            if verbatim:
                print(f"Tolerance set to {tol}.")
            if stats is not None:
                stats["tol_auto"] = tol

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
                return capture.hook("hamiltonian", hamiltonian, Whalf, Whalf,
                                    **kw)

            force = None
            if forcing is not None:
                def force(P, Whalf):
                    kw = {"time": time} if force_timed else {}
                    return capture.hook("forcing", forcing, Whalf, P, Whalf,
                                        **kw)

            return _iteration(Wh, dW, ham, force, skewh, vareps,
                              float(dt_half))

        strang = None
        if strang_splitting is not None:
            def strang(S):
                return capture.hook("strang_splitting", strang_splitting, S,
                                    float(dt) / 2, S)

        def host(A):
            return config.like_input(A, W)

        def update(W, rest, csum):
            """W after the step's update from the last iteration's rest: the
            Kahan-compensated (or plain) W += 2 PWc, then the forcing."""
            PWc, FW = rest
            upd = 2.0 * PWc
            if compsum:
                # Kahan compensated summation W += upd
                y = upd - csum
                tS = W + y
                csum = (tS - W) - y
                W = tS
            else:
                W = W + upd
            if forcing is not None:
                W = W + 2.0 * FW
            return W, csum

        timed_hooks = ham_timed or force_timed
        key = _capture_key("isomp", Wt, skewh, vareps, float(dt_half), *hooks,
                           ham_timed, force_timed,
                           None if strang is None else float(dt), compsum,
                           bool(reinitialize))
    if key is not None:
        def on_step(W_prev, W_new, rest):
            callback(host(W_prev), host(2.0 * rest[0]))

        def make():
            return _CapturedLoop(iteration, update, Wt, strang, reinitialize,
                                 (dt_half, dt_r) if timed_hooks else None)

        with _fixed_point_loop(key, make) as loop:
            Wt, total_iters, total_maxit = loop.run(
                Wt, steps, tol_r, maxit, minit, t,
                None if callback is None else on_step)
    else:
        loop = _Loop(iteration, Wt, strang)
        csum = torch.zeros_like(Wt) if compsum else None
        total_iters = total_maxit = 0
        with tracing.span("quflow.runner.launch", launches=0, steps=steps):
            for _ in range(steps):
                W_prev = Wt
                if strang is not None:
                    Wt = loop.strang(Wt)
                if reinitialize:
                    loop.reset()
                (PWc, FW), i, hit = loop(Wt, tol_r, maxit, minit,
                                         float(t + dt_half) if timed_hooks
                                         else None)
                Wt, csum = update(Wt, (PWc, FW), csum)
                if timed:
                    t = t + dt_r
                if strang is not None:
                    Wt = loop.strang(Wt)
                if callback is not None:
                    callback(host(W_prev), host(2.0 * PWc))
                total_iters += i
                total_maxit += int(hit)

    with tracing.span("quflow.integrator.finish"):
        if verbatim:
            print("Average number of iterations per step: {:.2f}".format(
                total_iters / steps))
        if stats is not None:
            stats["iterations"] = total_iters / steps
            stats["number_of_maxit"] = total_maxit / steps
        return _returned(W, Wt)


def _returned(W, Wt):
    """The result ``Wt`` as the integrator returns it for the input ``W``:
    a tensor as it is; for a numpy state, copied to the host into W."""
    if isinstance(W, np.ndarray):
        with tracing.host_read("state"):
            np.copyto(W, Wt.cpu().numpy())
        return W
    return Wt


isomp = isomp_fixedpoint


# ---------------------------------------------------------------------------
# quasi-Newton and simplified variants (host/scipy validation integrators)
# ---------------------------------------------------------------------------

def _host_state(W, device):
    """(a host copy of W, the device its Hamiltonian solves on, the
    function that returns a host result as W's kind)."""
    if isinstance(W, torch.Tensor):
        dev = W.device if device is None else device
        return (W.cpu().numpy().copy(), dev,
                lambda A: torch.from_numpy(A).to(W.device))
    return np.array(W, copy=True), device, lambda A: A


def isomp_quasinewton(
    W, dt, steps=100, hamiltonian=None, forcing=None, tol="auto", maxit=10,
    verbatim=False, skewh=True, *, device=None, **kwargs
):
    """Isospectral midpoint via quasi-Newton iteration: exactly isospectral
    (conjugation update W <- A^H Wtilde A with A = I - (eps/2) Ptilde).
    Runs on the host with scipy, as in quflow_tpu; the Hamiltonian solves on
    ``device`` (a tensor state's own by default)."""
    import scipy.linalg

    if forcing is not None:
        raise NotImplementedError("Forcing for isomp_quasinewton is not implemented.")
    W_host, dev, back = _host_state(W, device)
    if hamiltonian is None:
        hamiltonian = partial(solve_poisson, skewh=skewh, device=dev)

    stepsize = dt / hbar(W.shape[-1])
    if tol == "auto" or (np.isscalar(tol) and tol < 0):
        tol = float(
            np.finfo(W_host.dtype).eps
            * stepsize
            * np.linalg.norm(W_host, np.inf)
        )

    Id = np.eye(W.shape[-1])
    Wtilde = W_host.copy()
    total_iterations = 0

    for k in range(steps):
        for _i in range(maxit):
            total_iterations += 1
            Ptilde = np.asarray(hamiltonian(Wtilde))
            A = Id - (stepsize / 2.0) * Ptilde
            luA, piv = scipy.linalg.lu_factor(A)
            B = scipy.linalg.lu_solve((luA, piv), W_host)
            Wtilde_new = scipy.linalg.lu_solve((luA, piv), -B.conj().T)
            resnorm = scipy.linalg.norm(Wtilde - Wtilde_new, np.inf)
            Wtilde = Wtilde_new
            if resnorm < tol:
                break
        else:
            if verbatim:
                print(f"Max iterations {maxit} reached at step {k}.")
        W_host = A.conj().T @ Wtilde @ A

    if verbatim:
        print(
            "Average number of iterations per step: {:.2f}".format(
                total_iterations / steps
            )
        )
    if isinstance(W, np.ndarray):
        np.copyto(W, W_host)
        return W
    return back(W_host)


def isomp_simple(W, dt, steps=100, hamiltonian=None, forcing=None, skewh=True,
                 *, device=None, **kwargs):
    """Simplified (explicit, isospectral, non-symplectic) midpoint variant,
    on the host with scipy as in quflow_tpu; the Hamiltonian solves on
    ``device`` (a tensor state's own by default)."""
    import scipy.linalg

    if forcing is not None:
        raise NotImplementedError("Forcing for isomp_simple is not implemented.")
    W_host, dev, back = _host_state(W, device)
    if hamiltonian is None:
        hamiltonian = partial(solve_poisson, skewh=skewh, device=dev)

    Id = np.eye(W.shape[-1])
    stepsize = dt / hbar(W.shape[-1])
    Wtilde = W_host.copy()

    for _k in range(steps):
        Ptilde = np.asarray(hamiltonian(Wtilde))
        A = Id - (stepsize / 2.0) * Ptilde
        if skewh:
            luA, piv = scipy.linalg.lu_factor(A)
            X = scipy.linalg.lu_solve((luA, piv), W_host)
            Wtilde = scipy.linalg.lu_solve((luA, piv), -X.conj().T)
            W_new = A.conj().T @ Wtilde @ A
        else:
            X = np.linalg.solve(A, W_host)
            Aalt = Id + (stepsize / 2.0) * Ptilde
            Wtilde = np.linalg.solve(Aalt.conj().T, X.conj().T).conj().T
            W_new = Aalt @ Wtilde @ A
        W_host = W_new

    if isinstance(W, np.ndarray):
        np.copyto(W, W_host)
        return W
    return back(W_host)
