#!/usr/bin/env python3
"""Smoke test of quflow_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA device, nvcc, and nothing
of JAX.  Sixteen phases, one line each (phases 14-16 one for each of
their parts); any failure ends the run with a nonzero exit code and no result
line.

1. device  - the card's name and power limit, as nvidia-smi reports them;
2. build   - nvcc builds csrc/shear_thomas.cu and csrc/shear_scan.cu for
             sm_90a, one compiler each, started together (seconds, ptxas
             register counts);
3. kernel  - ``shear_thomas`` against its plain PyTorch version on the card
             at N in {512, 1024, 2048, 4096} (the two main-path shapes and
             larger ones), batch in {1, 4, 8}, complex64 and complex128:
             bit-equal (max abs error 0); the kernel's time (CUDA graph
             replay), the plain version's (CUDA events), the bound and the
             kernel's share of it;
4. main path, complex64, N=1024 - EulerFlow initial data, ``solve`` with
             ``IsompTorch(maxit=5)`` built without ``device=``, as the README
             does (the default device, the card), 100 steps,
             energy/enstrophy logged every 20: the kernel launched exactly
             steps x maxit times plus once per energy log, enstrophy drift
             <= 1e-4, and a 10-step run through the kernel equal to one
             through the plain solve to <= 1e-5 relative; steps/s;
5. main path, complex128, N=512, 200 steps - relative drift of tr(W^2) and
             tr(W^3) <= 1e-10; steps/s;
6. scan    - ``shear_scan`` against its plain version on the card at the
             shapes of phase 3: bit-equal; times as in phase 3, of
             ``shear_thomas`` on the same input too, the relative
             difference of the two kernels, the bound and the share; then,
             untimed, bit-equal at ragged shapes that cross the kernel's
             seams (N in {1, 7, 100, 257, 1000}: below one chunk, a short
             last chunk, chunks that do not fill the cluster's blocks, a
             last tile of one or two columns; batch in {1, 3});
7. MHD path, complex64, N=1024 - MHDFlow initial data, ``solve`` with
             ``MagmpTorch(maxit=5)`` under QUFLOW_PALLAS_KERNEL=scan, 100
             steps, invariants logged every 20 (kinetic + magnetic energy,
             cross helicity, as benchmarks/mhd_device.py computes them):
             the integrator launched ``shear_scan`` exactly steps x maxit
             times and ``shear_thomas`` never (the logs' solves counted
             apart), energy drift <= 1e-4, Theta's spectrum drift
             max|dlambda|/max|lambda| <= 1e-4, 10 steps through the kernel
             equal to 10 through the plain scan to <= 1e-5 relative (and
             the difference against the Thomas kernel); steps/s;
8. MHD path, complex128, N=512, 200 steps through ``shear_scan`` -
             relative drift of tr(Theta^2) and tr(Theta^3) <= 1e-10; cross
             helicity drift; steps/s;
9. MHD path, complex64, N=4096, 5 steps of the card-resident stepper
             through ``shear_scan``: finite; launches; steps/s;
10. reference path, complex128, N=1024 - the README's call: EulerFlow
             initial data, ``solve(W0, stepsize=0.25, steps=100,
             steps_out=20)`` with no integrator and no device (``isomp``,
             tol 'auto', maxit 10, on the card), energy/enstrophy logged:
             ``shear_thomas`` launched once per fixed-point iteration (the
             stats' average times the steps) plus once per energy log, one
             host sync per iteration; the Casimir drift under tol 'auto'
             reported, and the gate: the same run at tol=1e-12, compsum,
             maxit=20 drifts tr(W^2), tr(W^3) <= 1e-10; 10 steps through
             the kernel equal to 10 through the plain column solve to
             <= 1e-12 relative; iterations a step, steps/s, and the share of
             host time spent in the per-iteration ``.item()``;
11. reference path, complex64, N=1024 - ``GlobalQGFlow(gamma=1).step``
             (``isomp`` with ``solve_globalqg``), 50 steps under
             QUFLOW_PALLAS_KERNEL=scan: ``shear_scan`` launched once per
             iteration and ``shear_thomas`` never; finite; enstrophy drift
             <= 1e-3 (tol 'auto' in complex64 is float32-scale); the
             seconds of the QG operator's first use (host factorization
             and upload), then steps/s;
12. the Poisson family on the card, N=1024, complex128 and complex64 -
             ``solve_poisson``, ``solve_heat``, ``solve_helmholtz``,
             ``solve_viscdamp`` (theta 1 and 0.5) and ``solve_globalqg`` on
             a seeded skew-Hermitian matrix: one launch a call, the kernel
             bit-equal to the same call with the plain column solve,
             complex128 within 1e-12 relative of a host float64 reference
             (scipy banded solves, column by column) and complex64's error
             against it reported; laplace(solve_poisson(W)) = W to 1e-10;
13. reference MHD path, complex128, N=512 - 50 steps of
             ``MHDFlow.step`` (``magmp``) at tol=1e-12, maxit=20: one
             launch per iteration (``laplace`` of Theta launches none);
             tr(Theta^2), tr(Theta^3) drift <= 1e-10; steps/s;
14. the hooked production stepper:
    a. forced-dissipative QG, complex64, N=1024 - ``GlobalQGFlow.stepper``
       with diagnostics, a timed forcing cos(t) F0 (F0 band-limited,
       l in [8, 12], 1e-2 of W0's norm) and the viscdamp Strang splitting
       (theta 0.5), 100 steps in calls of 20 on a card tensor: exactly
       steps (maxit + 2) + calls ``shear_thomas`` launches (the fixed-point
       solves, the two Strang half-steps, the diagnostics), none of the
       scan; 10 steps through the kernel equal to 10 through the plain
       solve to <= 1e-5 relative; steps/s beside phase 4's;
    b. the same under QUFLOW_PALLAS_KERNEL=scan, 20 steps in one call:
       ``shear_scan`` alone, 20 (maxit + 2) + 1 launches; 10 steps against
       the plain scan to <= 1e-5;
    c. the same configuration in complex128 at N=512 as a stepper with
       tol=1e-300, minit=maxit=5 and as ``isomp`` with the callable
       Hamiltonian, forcing and Strang splitting, 20 steps each: within
       1e-11 of max|W|; the stepper's host syncs, one an iteration;
    d. adaptive tol, Euler complex128, N=1024 - ``build_step_fn(tol=1e-12,
       minit=1, maxit=20, compsum=True)``, 100 steps in calls of 20: one
       launch and one host sync an iteration, the trajectory within 1e-11
       relative of phase 10's gate run (``isomp``, the same tol), mean
       iterations a step within 0.1 of its, tr(W^2), tr(W^3) drift
       <= 1e-10;
    e. MHD hooks, complex64, N=1024, under QUFLOW_PALLAS_KERNEL=scan -
       ``build_mhd_step_fn`` with a fixed full-state forcing and the heat
       Strang splitting (both components in one launch), 20 steps:
       20 (maxit + 2) ``shear_scan`` launches; 5 steps against the plain
       scan to <= 1e-5;
    f. ``solve`` of a card tensor with ``IsompTorch`` (complex64, N=1024,
       100 steps, outputs every 20): a card tensor back, no host copy of
       any tensor (``Tensor.cpu``/``numpy``/``item``/``tolist`` counted),
       steps/s beside phase 4's numpy figure;
15. ensembles (``batched=True``):
    a. Euler, complex64, N=1024, maxit 5, B in {1, 4, 16} members
       (EulerFlow initial data of seeds 42, 43, ...), two calls of 20
       steps: exactly 40 x 5 ``shear_thomas`` launches whatever B (one
       launch solves every member); per-state steps/s; from one profiled
       call the card's ms a step (torch.profiler, the kernels' own time),
       ``shear_thomas``'s ms a step, and the share of the step the card
       idles;
    b. each member of the B=16 ensemble against its own unbatched run
       over 10 steps: within 1e-5 of max|W|;
    c. Euler, complex128, N=512, B=8, 200 steps: tr(W^2), tr(W^3) drift
       <= 1e-10 on every member;
    d. MHD, complex64, N=1024, B=4, heat Strang splitting, 20 steps under
       QUFLOW_PALLAS_KERNEL=scan: 20 (maxit + 2) ``shear_scan`` launches,
       each fixed-point solve of B=4 and each Strang half-step of 2 B = 8
       (both components of every member); 5 steps against the plain scan
       to <= 1e-5;
    e. ``shear_thomas`` at N=1024, B=16 and ``shear_scan`` at N=1024, B=2
       against their plain versions, as in phases 3 and 6 (bit-equal,
       times, bounds);
16. persistence and distribution on the card:
    a. ``IsompTorch(warm=False)``, complex64, N=1024: two calls of 20
       steps against 20 steps, ``save_checkpoint``, ``load_checkpoint``
       and 20 steps: bit-equal;
    b. a one-rank NCCL process group through ``initialize`` and
       ``global_mesh``: phase 15a's B=16 run on the mesh, bit-equal with
       the same launches; an adaptive run on the mesh (one all_reduce of
       the residual an iteration, counted) equal to the same run without
       it.

Every path (phases 4, 5, 7-16) runs with every launch count set to 0 just
before it and read just after.  Then a JSON line of the kernels
(name, source, the TPU kernel it replaces, launches on each path, error,
times and bound at the main path's shape; ``library_ms`` null, since no
PyTorch call solves banded or tridiagonal systems) and, last, the result
line ``{"ok": true, "device": {...}}``.

The bound of a column solve is the larger of its bytes (d, w, binv, u read
once, x written once) over 3.35 TB/s and its 10 real operations an element
(re and im: a multiply and a subtract forward, two multiplies and a
subtract backward) over the card's peak outside the tensor cores (67
TFLOP/s float32, 34 float64): NVIDIA's data sheet of the H100 SXM.
"""

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from scipy.linalg import solve_banded

from quflow_tpu_torch import (
    energy_euler,
    enstrophy,
    hbar,
    isomp,
    random_shr,
    shr2mat,
    solve,
)
from quflow_tpu_torch.integrators import isospectral
from quflow_tpu_torch.laplacian import tridiagonal
from quflow_tpu_torch.models import EulerFlow, GlobalQGFlow, MHDFlow
from quflow_tpu_torch.ops import cuda_build, cuda_scan_solve, cuda_solve
from quflow_tpu_torch.ops.laplacian import (
    laplace,
    solve_globalqg,
    solve_heat,
    solve_helmholtz,
    solve_poisson,
    solve_viscdamp,
)
from quflow_tpu_torch.ops.tridiag import shear_operator
from quflow_tpu_torch.ops.cuda_scan_solve import (
    shear_scan,
    shear_scan_reference,
)
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.parallel import stepper
from quflow_tpu_torch.parallel.stepper import (
    IsompTorch,
    MagmpTorch,
    _laplace_core,
    _mhd_lap_op,
    _real_factors,
    build_mhd_step_fn,
    build_step_fn,
)

KERNELS = (shear_thomas, shear_scan)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.complex64: 67e12, torch.complex128: 34e12}


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def read_counts():
    return {k.__name__: k.launches for k in KERNELS}


def ptxas_summary(log):
    """The register and spill lines of nvcc's ``-Xptxas -v`` report."""
    return " | ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card: ``reps`` calls
    captured in one CUDA graph after a warm-up call, the graph replayed
    once and then timed by CUDA events, so that the host's time to launch
    does not enter a kernel's."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def solve_bound(N, B, dtype):
    """The least time (ms) the card could take for a column solve of B
    complex (N, N+1) arrays, and what bounds it: 'bytes' or 'operations'
    (see the module's note)."""
    real = 4 if dtype == torch.complex64 else 8
    elements = N * (N + 1)
    t_bytes = (4 * real * B + 3 * real) * elements / HBM_BYTES_PER_S
    t_ops = 10 * B * elements / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def solve_inputs(device, Ns, Bs):
    """(dtype, N, B, w, binv, u, d) for both dtypes, every N and B: the
    Poisson factors and a seeded random rhs on ``device``."""
    for dtype in (torch.complex64, torch.complex128):
        for N in Ns:
            w, binv, u = _real_factors(N, dtype, device=device)
            for B in Bs:
                g = torch.Generator(device=device).manual_seed(1000 * N + B)
                yield dtype, N, B, w, binv, u, torch.randn(
                    B, N, N + 1, dtype=dtype, device=device, generator=g)


def bit_equal(kernel, plain, dtype, N, B, w, binv, u, d):
    """``kernel`` and ``plain`` on the same input: the kernel's result and
    the max abs error, which must be 0 (the same roundings in the same
    order)."""
    x = kernel(w, binv, u, d)
    abs_err = (x - plain(w, binv, u, d)).abs().max().item()
    if abs_err != 0.0:
        raise AssertionError(
            f"{kernel.__name__} {dtype} N={N} B={B}: max abs error "
            f"{abs_err:.3e}, not bit-equal")
    return x, abs_err


def kernel_vs_plain(device, Ns=(512, 1024, 2048, 4096), Bs=(1, 4, 8),
                    reps=20, plain_reps=2, kernel=shear_thomas,
                    plain=shear_thomas_reference, against=None):
    """Phases 3 and 6: ``kernel`` against ``plain``, one row per (dtype, N,
    B): bit-equal; at B=8 one timed call of the plain version.  With
    ``against``, that kernel's time on the same input and the relative
    difference of the two."""
    rows = []
    for dtype, N, B, w, binv, u, d in solve_inputs(device, Ns, Bs):
        x, abs_err = bit_equal(kernel, plain, dtype, N, B, w, binv, u, d)
        bound_ms, bound_by = solve_bound(N, B, dtype)
        ms = graph_ms(lambda: kernel(w, binv, u, d), reps)
        row = dict(
            dtype=str(dtype).removeprefix("torch."), N=N, B=B,
            max_abs_err=abs_err, ms=ms,
            plain_ms=cuda_ms(lambda: plain(w, binv, u, d),
                             plain_reps if B < 8 else 1),
            bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms)
        if against is not None:
            other = against(w, binv, u, d)
            row[f"vs_{against.__name__}_rel"] = (
                (x - other).abs().max() / other.abs().max()).item()
            row[f"{against.__name__}_ms"] = graph_ms(
                lambda: against(w, binv, u, d), reps)
        rows.append(row)
    return rows


def ragged_bit_equal(device, kernel, plain, Ns=(1, 7, 100, 257, 1000),
                     Bs=(1, 3)):
    """``kernel`` against ``plain`` at shapes that cross the kernel's
    seams, untimed: one row per (dtype, N, B), bit-equal or it raises."""
    return [dict(dtype=str(dtype).removeprefix("torch."), N=N, B=B,
                 max_abs_err=bit_equal(kernel, plain, dtype, N, B, *rest)[1])
            for dtype, N, B, *rest in solve_inputs(device, Ns, Bs)]


class Logger:
    """A plain-Python solve callback: energy and enstrophy per output, and
    the steps and integrator stats that solve hands to each output."""

    def __init__(self):
        self.rows = []
        self.chunks = []

    def __call__(self, W, delta_time=0.0, delta_steps=0, **stats):
        self.rows.append((float(energy_euler(W)), float(enstrophy(W))))
        if delta_steps:
            self.chunks.append((delta_steps, stats))


def main_path_c64(device, N=1024, steps=100, steps_out=20, maxit=5,
                  compare_steps=10):
    """Phase 4."""
    W0 = EulerFlow(N, np.complex64).random_initial(lmax=10, seed=42)
    # no device=: the README's call, so the default device is what runs
    integrator = IsompTorch(maxit=maxit, dtype=np.complex64)
    log = Logger()
    reset_counts()
    log(W0)
    t0 = time.perf_counter()
    W = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps_out,
              integrator=integrator, callback=log, progress_bar=False)
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["shear_thomas"]
    expected = steps * maxit + len(log.rows)
    if launches != expected or counts["shear_scan"]:
        raise AssertionError(f"launches on the main path {counts}, expected "
                             f"{expected} of shear_thomas only")
    if W.shape != (N, N) or W.dtype != np.complex64 or not np.isfinite(W).all():
        raise AssertionError(f"bad state: {W.shape} {W.dtype}")
    Z = np.array([r[1] for r in log.rows])
    z_drift = float(np.abs(Z - Z[0]).max() / abs(Z[0]))
    if not z_drift <= 1e-4:
        raise AssertionError(f"enstrophy drift {z_drift:.3e} > 1e-4")

    # the same steps through the kernel and through the plain solve
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)
    Wk = build_step_fn(N, dt, steps=compare_steps, maxit=maxit,
                       dtype=np.complex64, device=device)(Wt, z, z)[0]
    Wp = build_step_fn(N, dt, steps=compare_steps, maxit=maxit,
                       dtype=np.complex64, device=device,
                       solver=shear_thomas_reference)(Wt, z, z)[0]
    step_rel = ((Wk - Wp).abs().max() / Wp.abs().max()).item()
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")

    # stepper throughput alone, state resident on the card
    fn = build_step_fn(N, dt, steps=steps_out, maxit=maxit,
                       dtype=np.complex64, device=device)
    st = fn(Wt, z, z)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps // steps_out):
        st = fn(*st)
    torch.cuda.synchronize()
    stepper_s = time.perf_counter() - t0
    return dict(N=N, steps=steps, maxit=maxit, launches=launches,
                expected_launches=expected, enstrophy_drift=z_drift,
                energy_drift=float(abs(log.rows[-1][0] - log.rows[0][0])
                                   / abs(log.rows[0][0])),
                kernel_vs_plain_10_steps=step_rel,
                solve_steps_per_s=steps / solve_s,
                stepper_steps_per_s=steps / stepper_s)


def casimirs(W):
    """[tr(W^2) (real), tr(W^3) (imaginary part)] of W (..., N, N), numpy
    (..., 2)."""
    W2 = W @ W

    def trace(A):
        return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)

    return torch.stack([trace(W2).real, trace(W2 @ W).imag], -1).cpu().numpy()


def main_path_c128(device, N=512, steps=200, maxit=5):
    """Phase 5."""
    W0 = EulerFlow(N, np.complex128).random_initial(lmax=10, seed=42)
    c0 = casimirs(torch.from_numpy(W0).to(device))
    reset_counts()
    t0 = time.perf_counter()
    W = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps,
              integrator=IsompTorch(maxit=maxit, dtype=np.complex128,
                                    device=device), progress_bar=False)
    sec = time.perf_counter() - t0
    launches = read_counts()
    if launches != {"shear_thomas": steps * maxit, "shear_scan": 0}:
        raise AssertionError(f"launches {launches}")
    if not np.isfinite(W).all():
        raise AssertionError("non-finite state")
    drift = np.abs(casimirs(torch.from_numpy(W).to(device)) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(W^2), tr(W^3) = {drift} > 1e-10")
    return dict(N=N, steps=steps, maxit=maxit, launches=launches,
                tr_W2_drift=drift[0], tr_W3_drift=drift[1],
                solve_steps_per_s=steps / sec)


class MHDLogger:
    """A solve callback: the MHD invariants of each output, as
    benchmarks/mhd_device.py:160-169 computes them (kinetic energy through
    the Poisson solve of ``energy_euler``, magnetic energy -<B, Theta>/2
    with B the Laplacian of Theta, cross helicity <W, Theta>), on the
    card.  Counts apart the kernel launches made by its own solves."""

    def __init__(self, N, device):
        self.lap = _mhd_lap_op(N, np.complex128, device=device)
        self.device = device
        self.rows = []
        self.launches = dict.fromkeys(read_counts(), 0)

    def __call__(self, S, delta_time=0.0, delta_steps=0, **stats):
        before = read_counts()
        kinetic = float(energy_euler(S[0]))
        St = torch.from_numpy(np.asarray(S)).to(self.device, torch.complex128)
        W, Theta = St[0], St[1]
        N = W.shape[-1]
        B = _laplace_core(Theta, self.lap)
        magnetic = -0.5 * (torch.sum(B * Theta.conj()).real / N).item()
        cross = (torch.sum(W * Theta.conj()).real / N).item()
        self.rows.append((kinetic + magnetic, cross))
        for name, n in read_counts().items():
            self.launches[name] += n - before[name]


@contextlib.contextmanager
def kernel_variable(name):
    """QUFLOW_PALLAS_KERNEL set to ``name`` inside the block only."""
    saved = os.environ.get("QUFLOW_PALLAS_KERNEL")
    os.environ["QUFLOW_PALLAS_KERNEL"] = name
    try:
        yield
    finally:
        if saved is None:
            del os.environ["QUFLOW_PALLAS_KERNEL"]
        else:
            os.environ["QUFLOW_PALLAS_KERNEL"] = saved


def theta_spectrum(S, device):
    Theta = torch.from_numpy(np.asarray(S[1])).to(device, torch.complex128)
    return torch.linalg.eigvalsh(-1j * Theta)


def mhd_c64(device, N=1024, steps=100, steps_out=20, maxit=5,
            compare_steps=10):
    """Phase 7, with QUFLOW_PALLAS_KERNEL=scan set for this phase only."""
    S0 = MHDFlow(N, np.complex64).random_initial(lmax=10, seed=42)
    lam0 = theta_spectrum(S0, device)
    with kernel_variable("scan"):
        integrator = MagmpTorch(maxit=maxit, dtype=np.complex64, device=device)
        log = MHDLogger(N, device)
        reset_counts()
        log(S0)
        t0 = time.perf_counter()
        S = solve(S0.copy(), stepsize=0.25, steps=steps, steps_out=steps_out,
                  integrator=integrator, callback=log, progress_bar=False)
        solve_s = time.perf_counter() - t0
        total = read_counts()
    integ = {k: total[k] - log.launches[k] for k in total}
    if integ != {"shear_thomas": 0, "shear_scan": steps * maxit}:
        raise AssertionError(f"the integrator launched {integ}, expected "
                             f"{steps * maxit} of shear_scan only")
    if sum(log.launches.values()) != len(log.rows):
        raise AssertionError(f"the logs launched {log.launches} for "
                             f"{len(log.rows)} energies")
    if (S.shape != (2, N, N) or S.dtype != np.complex64
            or not np.isfinite(S).all()):
        raise AssertionError(f"bad state: {S.shape} {S.dtype}")
    E = np.array([r[0] for r in log.rows])
    e_drift = float(np.abs(E - E[0]).max() / abs(E[0]))
    if not e_drift <= 1e-4:
        raise AssertionError(f"total energy drift {e_drift:.3e} > 1e-4")
    lam = theta_spectrum(S, device)
    spec_drift = ((lam - lam0).abs().max() / lam0.abs().max()).item()
    if not spec_drift <= 1e-4:
        raise AssertionError(f"Theta spectrum drift {spec_drift:.3e} > 1e-4")
    X = np.array([r[1] for r in log.rows])

    # the same steps through the kernel, its plain version, and shear_thomas
    dt = 0.25 * hbar(N)
    St = torch.from_numpy(S0).to(device)
    z = torch.zeros_like(St)

    def run(solver, steps=compare_steps):
        return build_mhd_step_fn(N, dt, steps=steps, maxit=maxit,
                                 dtype=np.complex64, device=device,
                                 solver=solver)

    Sk = run(shear_scan)(St, z, z)[0]
    Sp = run(shear_scan_reference)(St, z, z)[0]
    St_thomas = run(shear_thomas)(St, z, z)[0]
    step_rel = ((Sk - Sp).abs().max() / Sp.abs().max()).item()
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")
    vs_thomas = ((Sk - St_thomas).abs().max() / St_thomas.abs().max()).item()

    # stepper throughput alone, state resident on the card
    fn = run(shear_scan, steps_out)
    st = fn(St, z, z)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps // steps_out):
        st = fn(*st)
    torch.cuda.synchronize()
    stepper_s = time.perf_counter() - t0
    return dict(N=N, steps=steps, maxit=maxit, integrator_launches=integ,
                log_launches=log.launches, energy_drift=e_drift,
                theta_spectrum_drift=spec_drift,
                cross_helicity_drift=float(np.abs(X - X[0]).max()
                                           / abs(X[0])),
                kernel_vs_plain_10_steps=step_rel,
                scan_vs_thomas_10_steps=vs_thomas,
                solve_steps_per_s=steps / solve_s,
                stepper_steps_per_s=steps / stepper_s)


def mhd_c128(device, N=512, steps=200, maxit=5):
    """Phase 8."""
    S0 = MHDFlow(N, np.complex128).random_initial(lmax=10, seed=42)
    S0t = torch.from_numpy(S0).to(device)
    c0 = casimirs(S0t[1])
    x0 = (torch.sum(S0t[0] * S0t[1].conj()).real / N).item()
    reset_counts()
    t0 = time.perf_counter()
    S = solve(S0.copy(), stepsize=0.25, steps=steps, steps_out=steps,
              integrator=MagmpTorch(maxit=maxit, dtype=np.complex128,
                                    device=device, solver=shear_scan),
              progress_bar=False)
    sec = time.perf_counter() - t0
    launches = read_counts()
    if launches != {"shear_thomas": 0, "shear_scan": steps * maxit}:
        raise AssertionError(f"launches {launches}")
    if not np.isfinite(S).all():
        raise AssertionError("non-finite state")
    St = torch.from_numpy(S).to(device)
    drift = np.abs(casimirs(St[1]) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(Theta^2), tr(Theta^3) = "
                             f"{drift} > 1e-10")
    x1 = (torch.sum(St[0] * St[1].conj()).real / N).item()
    return dict(N=N, steps=steps, maxit=maxit, launches=launches,
                tr_Theta2_drift=drift[0], tr_Theta3_drift=drift[1],
                cross_helicity_drift=abs(x1 - x0) / abs(x0),
                solve_steps_per_s=steps / sec)


def mhd_large(device, N=4096, steps=5, maxit=5):
    """Phase 9: the card-resident stepper through shear_scan."""
    S0 = torch.from_numpy(MHDFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    z = torch.zeros_like(S0)
    dt = 0.25 * hbar(N)

    def run(steps):
        return build_mhd_step_fn(N, dt, steps=steps, maxit=maxit,
                                 dtype=np.complex64, device=device,
                                 solver=shear_scan)

    run(1)(S0, z, z)  # first call: allocations, cuBLAS set-up
    fn = run(steps)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    S = fn(S0, z, z)[0]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    if launches != {"shear_thomas": 0, "shear_scan": steps * maxit}:
        raise AssertionError(f"launches {launches}")
    if not torch.isfinite(torch.view_as_real(S)).all().item():
        raise AssertionError("non-finite state")
    return dict(N=N, steps=steps, maxit=maxit, launches=launches,
                stepper_steps_per_s=steps / sec)


class SyncTimer:
    """Counts the host syncs of a fixed-point loop with a tolerance (one
    ``.item()`` of the residual norm an iteration: ``_residual`` of
    integrators/isospectral for isomp, of parallel/stepper for the
    steppers) and the host seconds spent in them, while installed."""

    def __init__(self, module=isospectral):
        self.module = module
        self.calls = 0
        self.seconds = 0.0

    def __enter__(self):
        self._residual = self.module._residual

        def timed(a, b):
            t0 = time.perf_counter()
            rn = self._residual(a, b)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return rn

        self.module._residual = timed
        return self

    def __exit__(self, *exc):
        self.module._residual = self._residual


def chunk_iterations(log):
    """Fixed-point iterations of a solve run, from the stats its
    callback got: each chunk's average a step times its steps."""
    return round(sum(n * st["iterations"] for n, st in log.chunks))


def reference_euler(device, N=1024, steps=100, steps_out=20,
                    compare_steps=10, gate_out=None):
    """Phase 10: the README's call on the card, complex128.  ``gate_out``,
    a dict, gets the gate run's initial and final states and its
    iterations a step (phase 14d holds the stepper to them)."""
    W0 = EulerFlow(N, np.complex128).random_initial(lmax=10, seed=42)
    c0 = casimirs(torch.from_numpy(W0).to(device))
    log = Logger()
    reset_counts()
    log(W0)
    with SyncTimer() as syncs:
        t0 = time.perf_counter()
        # no integrator= and no device=: isomp, tol 'auto', maxit 10, the card
        W = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps_out,
                  callback=log, progress_bar=False)
        wall = time.perf_counter() - t0
    counts = read_counts()
    iterations = chunk_iterations(log)
    expected = iterations + len(log.rows)
    if counts != {"shear_thomas": expected, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}, expected {expected} of "
                             f"shear_thomas: {iterations} fixed-point "
                             f"iterations and {len(log.rows)} energy logs")
    if syncs.calls != iterations:
        raise AssertionError(f"{syncs.calls} host syncs for {iterations} "
                             "iterations")
    if W.shape != (N, N) or W.dtype != np.complex128 or not np.isfinite(W).all():
        raise AssertionError(f"bad state: {W.shape} {W.dtype}")
    auto_drift = np.abs(casimirs(torch.from_numpy(W).to(device)) - c0
                        ) / np.abs(c0)
    Z = np.array([r[1] for r in log.rows])

    # the conservation gate: tests/test_integrators.py's tolerance
    gate = Logger()
    reset_counts()
    t0 = time.perf_counter()
    Wg = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps,
               tol=1e-12, compsum=True, maxit=20, callback=gate,
               progress_bar=False)
    gate_s = time.perf_counter() - t0
    gate_iterations = chunk_iterations(gate)
    gate_counts = read_counts()
    if gate_counts["shear_thomas"] != gate_iterations + len(gate.rows):
        raise AssertionError(f"gate launches {gate_counts} for "
                             f"{gate_iterations} iterations")
    drift = np.abs(casimirs(torch.from_numpy(Wg).to(device)) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(W^2), tr(W^3) = {drift} > "
                             "1e-10 at tol=1e-12, compsum")
    if gate_out is not None:
        gate_out.update(W0=W0, W=Wg, steps=steps,
                        iterations_per_step=gate_iterations / steps)

    # the same steps through the kernel and through the plain column solve
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    Wk = isomp(Wt, dt, compare_steps)
    Wp = isomp(Wt, dt, compare_steps, hamiltonian=functools.partial(
        solve_poisson, skewh=True, solver=shear_thomas_reference))
    step_rel = ((Wk - Wp).abs().max() / Wp.abs().max()).item()
    if not step_rel <= 1e-12:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-12")
    return dict(N=N, steps=steps, launches=counts["shear_thomas"],
                expected_launches=expected,
                iterations_per_step=iterations / steps,
                syncs=syncs.calls, sync_s=syncs.seconds,
                sync_share=syncs.seconds / wall,
                solve_steps_per_s=steps / wall,
                auto_tr_W2_drift=auto_drift[0], auto_tr_W3_drift=auto_drift[1],
                auto_enstrophy_drift=float(np.abs(Z - Z[0]).max() / abs(Z[0])),
                gate_launches=gate_counts["shear_thomas"],
                gate_iterations_per_step=gate_iterations / steps,
                gate_tr_W2_drift=drift[0], gate_tr_W3_drift=drift[1],
                gate_steps_per_s=steps / gate_s,
                kernel_vs_plain_10_steps=step_rel)


def reference_qg(device, N=1024, steps=50, gamma=1.0):
    """Phase 11: GlobalQGFlow.step (isomp with solve_globalqg) in complex64
    through shear_scan."""
    flow = GlobalQGFlow(N, np.complex64, gamma=gamma)
    W0 = flow.random_initial(lmax=10, seed=42)
    z0 = enstrophy(W0.astype(np.complex128))
    stats = {}
    with kernel_variable("scan"):
        # the QG operator's first use factorizes it on the host and uploads
        # it: timed apart from the steps
        t0 = time.perf_counter()
        flow.hamiltonian(torch.from_numpy(W0).to(device))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        W = flow.step(W0.copy(), 0.25 * hbar(N), steps=steps, stats=stats)
        sec = time.perf_counter() - t0
        counts = read_counts()
    iterations = round(stats["iterations"] * steps)
    if counts != {"shear_thomas": 0, "shear_scan": iterations}:
        raise AssertionError(f"launches {counts}, expected {iterations} of "
                             "shear_scan only")
    if W.dtype != np.complex64 or not np.isfinite(W).all():
        raise AssertionError(f"bad state: {W.dtype}")
    z_drift = float(abs(enstrophy(W.astype(np.complex128)) - z0) / abs(z0))
    if not z_drift <= 1e-3:
        raise AssertionError(f"enstrophy drift {z_drift:.3e} > 1e-3")
    return dict(N=N, steps=steps, gamma=gamma, launches=counts,
                iterations_per_step=stats["iterations"],
                enstrophy_drift=z_drift, setup_s=setup_s,
                steps_per_s=steps / sec)


#: phase 12's solves: name -> (the port's call on W, the (kind, params) of
#: its shear operator, ops/tridiag.shear_operator)
FAMILIES = {
    "poisson": (lambda W, **kw: solve_poisson(W, skewh=True, **kw),
                ("poisson", ())),
    "heat": (lambda W, **kw: solve_heat(1e-3, W, skewh=True, **kw),
             ("heat", (1e-3,))),
    "helmholtz": (lambda W, **kw: solve_helmholtz(W, alpha=0.1, skewh=True,
                                                  **kw),
                  ("helmholtz", (0.1,))),
    "viscdamp_theta1": (lambda W, **kw: solve_viscdamp(
        0.1, W, nu=1e-2, alpha=0.6, theta=1, skewh=True, **kw),
        ("viscdamp", (0.1, 1e-2, 0.6, 1.0))),
    "viscdamp_theta05": (lambda W, **kw: solve_viscdamp(
        0.1, W, nu=1e-2, alpha=0.6, theta=0.5, skewh=True, **kw),
        ("viscdamp", (0.1, 1e-2, 0.6, 0.5))),
    "globalqg": (lambda W, **kw: solve_globalqg(W, gamma=0.7, skewh=True,
                                                **kw),
                 ("globalqg", (0.7,))),
}


def host_family_solve(name, W):
    """The float64 host reference of ``FAMILIES[name]``: Poisson through the
    row-packed LAPACK solve of laplacian.tridiagonal; every other family
    packed into the shear view, the trace projected, each column's
    tridiagonal system solved with scipy ``solve_banded``, the trace
    projected, unpacked, and the lower triangle mirrored."""
    N = W.shape[-1]
    if name == "poisson":
        return tridiagonal.solve_tridiagonal_lapack(
            tridiagonal.compute_tridiagonal_laplacian(N, bc=True), W)
    kind, params = FAMILIES[name][1]
    if kind == "viscdamp" and params[3] != 1:
        h, nu, alpha, theta = params
        lapW = laplace(torch.from_numpy(W), skewh=True).numpy()
        W = (1.0 - alpha * h * (1 - theta)) * W + (nu * h * (1 - theta)) * lapW
    op = shear_operator(N, kind, params)
    D = np.concatenate([W.reshape(-1), np.zeros(N, W.dtype)]).reshape(N, N + 1)
    D[:, 0] -= D[:, 0].mean()
    X = np.empty_like(D)
    ab = np.zeros((3, N))
    for j in range(N + 1):
        ab[0, 1:] = op[j, 1, :-1]
        ab[1] = op[j, 0]
        ab[2, :-1] = op[j, 1, :-1]
        X[:, j] = solve_banded((1, 1), ab, D[:, j])
    X[:, 0] -= X[:, 0].mean()
    P = X.reshape(-1)[: N * N].reshape(N, N)
    return np.tril(P) - np.tril(P, -1).conj().T


def poisson_family(device, N=1024):
    """Phase 12: every Poisson-family solve on tensors on the card, both
    dtypes: the kernel bit-equal to the plain column solve, complex128
    within 1e-12 of the host float64 reference, complex64's error beside
    it, one launch a call; laplace(solve_poisson(W)) = W."""
    rng = np.random.RandomState(12)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    W = W - W.conj().T
    W -= np.eye(N) * np.trace(W) / N
    rows = []
    for name, (call, _) in FAMILIES.items():
        ref = host_family_solve(name, W)
        row = dict(family=name)
        for dtype in (torch.complex128, torch.complex64):
            Wt = torch.from_numpy(W).to(device, dtype)
            reset_counts()
            P = call(Wt)
            launches = read_counts()
            if launches != {"shear_thomas": 1, "shear_scan": 0}:
                raise AssertionError(f"{name} {dtype}: launches {launches}")
            plain = call(Wt, solver=shear_thomas_reference)
            abs_err = (P - plain).abs().max().item()
            if abs_err != 0.0:
                raise AssertionError(f"{name} {dtype}: kernel vs plain "
                                     f"{abs_err:.3e}, not bit-equal")
            Ph = P.cpu().numpy()
            err = float(np.abs(Ph - ref).max() / np.abs(ref).max())
            tier = str(dtype).removeprefix("torch.")
            row[f"{tier}_rel_err"] = err
            row[f"{tier}_launches"] = launches["shear_thomas"]
            if dtype == torch.complex128 and not err <= 1e-12:
                raise AssertionError(f"{name} complex128: {err:.3e} > 1e-12 "
                                     "from the host reference")
        rows.append(row)
    Wt = torch.from_numpy(W).to(device)
    back = laplace(solve_poisson(Wt, skewh=True), skewh=True)
    round_trip = ((back - Wt).abs().max() / Wt.abs().max()).item()
    if not round_trip <= 1e-10:
        raise AssertionError(f"laplace(solve_poisson(W)) vs W: "
                             f"{round_trip:.3e} > 1e-10")
    return dict(N=N, families=rows, laplace_round_trip=round_trip,
                launches=sum(r["complex128_launches"] + r["complex64_launches"]
                             for r in rows))


def reference_mhd(device, N=512, steps=50):
    """Phase 13: MHDFlow.step (magmp) in complex128 at
    tests/test_mhd.py's tolerance."""
    flow = MHDFlow(N, np.complex128)
    S0 = flow.random_initial(lmax=10, seed=42)
    c0 = casimirs(torch.from_numpy(S0[1]).to(device))
    stats = {}
    reset_counts()
    t0 = time.perf_counter()
    S = flow.step(S0.copy(), 0.25 * hbar(N), steps=steps, tol=1e-12,
                  maxit=20, stats=stats)
    sec = time.perf_counter() - t0
    counts = read_counts()
    iterations = round(stats["iterations"] * steps)
    if counts != {"shear_thomas": iterations, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}, expected {iterations}: one "
                             "solve of W an iteration, laplace of Theta none")
    if not np.isfinite(S).all():
        raise AssertionError("non-finite state")
    drift = np.abs(casimirs(torch.from_numpy(S[1]).to(device)) - c0
                   ) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(Theta^2), tr(Theta^3) = "
                             f"{drift} > 1e-10")
    return dict(N=N, steps=steps, launches=counts["shear_thomas"],
                iterations_per_step=stats["iterations"],
                tr_Theta2_drift=drift[0], tr_Theta3_drift=drift[1],
                steps_per_s=steps / sec)


#: phase 14's forced-dissipative QG configuration
QG_GAMMA = 1.0
VISCDAMP = ("viscdamp", dict(nu=1e-4, alpha=0.01, theta=0.5))


def band_forcing(N, dtype, device, W0, scale=1e-2):
    """A fixed skew-Hermitian band-limited matrix F0 (``random_shr(lmax=12,
    seed=7)`` with l < 8 zeroed), scaled to ``scale`` times W0's Frobenius
    norm, on ``device``."""
    omega = random_shr(lmax=12, seed=7)
    omega[:8 ** 2] = 0.0
    F0 = shr2mat(omega, N=N)
    F0 *= scale * np.linalg.norm(W0) / np.linalg.norm(F0)
    return torch.from_numpy(F0.astype(dtype)).to(device)


def qg_forcing(F0):
    """The timed forcing cos(t) F0 of phase 14."""
    def forcing(P, W, time=0.0):
        return math.cos(time) * F0
    return forcing


def ratio(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def finite(x):
    return bool(torch.isfinite(torch.view_as_real(x) if x.is_complex()
                               else x).all().item())


def hooked_qg(device, kernel=shear_thomas, plain=shear_thomas_reference,
              N=1024, steps=100, steps_out=20, maxit=5, compare_steps=10):
    """Phases 14a (``shear_thomas``) and 14b (under
    QUFLOW_PALLAS_KERNEL=scan, ``shear_scan``): the forced-dissipative QG
    stepper, complex64."""
    flow = GlobalQGFlow(N, np.complex64, gamma=QG_GAMMA)
    W0 = flow.random_initial(lmax=10, seed=42)
    forcing = qg_forcing(band_forcing(N, np.complex64, device, W0))
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)

    def runner(n, **kw):
        return flow.stepper(dt, n, maxit=maxit, forcing=forcing,
                            strang_splitting=VISCDAMP, device=device, **kw)

    runner(1)(Wt, z, z, 0.0)  # first call: host factors, cuBLAS set-up
    fn = runner(steps_out, with_diagnostics=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    st = (Wt, z, z)
    for k in range(steps // steps_out):
        *st, diag = fn(*st, k * steps_out * dt)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    calls = steps // steps_out
    expected = {k.__name__: 0 for k in KERNELS}
    expected[kernel.__name__] = steps * (maxit + 2) + calls
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    W = st[0]
    if W.shape != (N, N) or W.dtype != torch.complex64 or not finite(W):
        raise AssertionError(f"bad state: {W.shape} {W.dtype}")
    if not finite(diag):
        raise AssertionError(f"non-finite diagnostics {diag}")

    # the same steps through the kernel and through its plain version
    Wk = runner(compare_steps, solver=kernel)(Wt, z, z, 0.0)[0]
    Wp = runner(compare_steps, solver=plain)(Wt, z, z, 0.0)[0]
    step_rel = ratio(Wk, Wp)
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")
    return dict(N=N, steps=steps, steps_per_call=steps_out, maxit=maxit,
                launches=counts, expected_launches=expected,
                energy=diag[0].item(), enstrophy=diag[1].item(),
                kernel_vs_plain_steps=compare_steps,
                kernel_vs_plain=step_rel, stepper_steps_per_s=steps / sec)


def hooked_vs_reference(device, N=512, steps=20, maxit=5):
    """Phase 14c: the forced-dissipative QG stepper against the reference
    loop ``isomp`` with the callable hooks, complex128."""
    flow = GlobalQGFlow(N, np.complex128, gamma=QG_GAMMA)
    W0 = flow.random_initial(lmax=10, seed=42)
    forcing = qg_forcing(band_forcing(N, np.complex128, device, W0))
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)
    fn = flow.stepper(dt, steps, maxit=maxit, minit=maxit, tol=1e-300,
                      forcing=forcing, strang_splitting=VISCDAMP,
                      device=device)
    reset_counts()
    with SyncTimer(stepper) as syncs:
        Ws, _, _, iters = fn(Wt, z, z, 0.0)
    stepper_counts = read_counts()
    if (iters != maxit).any() or syncs.calls != steps * maxit:
        raise AssertionError(f"iterations {iters.tolist()}, {syncs.calls} "
                             "host syncs")
    if stepper_counts["shear_thomas"] != steps * (maxit + 2):
        raise AssertionError(f"stepper launches {stepper_counts}")
    reset_counts()
    Wr = isomp(Wt, dt, steps, time=0.0, tol=1e-300, minit=maxit, maxit=maxit,
               compsum=True, forcing=forcing,
               hamiltonian=functools.partial(solve_globalqg, gamma=QG_GAMMA,
                                             skewh=True),
               strang_splitting=functools.partial(
                   solve_viscdamp, skewh=True, **VISCDAMP[1]))
    isomp_counts = read_counts()
    diff = ((Ws - Wr).abs().max() / Wr.abs().max()).item()
    if not diff <= 1e-11:
        raise AssertionError(f"stepper vs isomp: {diff:.3e} > 1e-11 of "
                             "max|W|")
    return dict(N=N, steps=steps, maxit=maxit, stepper_vs_isomp=diff,
                stepper_launches=stepper_counts["shear_thomas"],
                isomp_launches=isomp_counts["shear_thomas"],
                stepper_syncs=syncs.calls)


def adaptive_euler(device, gate, steps_out=20, tol=1e-12, maxit=20):
    """Phase 14d: adaptive tol on the Euler stepper, complex128, against
    phase 10's gate run (``gate``: its states and iterations)."""
    W0, steps = gate["W0"], gate["steps"]
    N = W0.shape[-1]
    c0 = casimirs(torch.from_numpy(W0).to(device))
    fn = build_step_fn(N, 0.25 * hbar(N), steps=steps_out, maxit=maxit,
                       dtype=np.complex128, compsum=True, tol=tol, minit=1,
                       device=device)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)
    series = []
    reset_counts()
    with SyncTimer(stepper) as syncs:
        t0 = time.perf_counter()
        st = (Wt, z, z)
        for _ in range(steps // steps_out):
            *st, iters = fn(*st)
            series.append(iters)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    counts = read_counts()
    iterations = int(torch.cat(series).sum())
    if counts != {"shear_thomas": iterations, "shear_scan": 0}:
        raise AssertionError(f"launches {counts} for {iterations} iterations")
    if syncs.calls != iterations:
        raise AssertionError(f"{syncs.calls} host syncs for {iterations} "
                             "iterations")
    W = st[0]
    rel = ratio(W, torch.from_numpy(gate["W"]).to(device))
    if not rel <= 1e-11:
        raise AssertionError(f"stepper vs isomp's gate run: {rel:.3e} > 1e-11")
    mean = iterations / steps
    if not abs(mean - gate["iterations_per_step"]) <= 0.1:
        raise AssertionError(f"{mean} iterations a step, isomp's gate "
                             f"{gate['iterations_per_step']}")
    drift = np.abs(casimirs(W) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(W^2), tr(W^3) = {drift}")
    return dict(N=N, steps=steps, tol=tol, maxit=maxit, launches=iterations,
                syncs=syncs.calls, sync_s=syncs.seconds,
                iterations_per_step=mean,
                isomp_iterations_per_step=gate["iterations_per_step"],
                vs_isomp_gate=rel, tr_W2_drift=drift[0], tr_W3_drift=drift[1],
                stepper_steps_per_s=steps / sec)


def hooked_mhd(device, N=1024, steps=20, maxit=5, compare_steps=5):
    """Phase 14e: the MHD stepper with a fixed full-state forcing and the
    named heat Strang splitting, complex64, under
    QUFLOW_PALLAS_KERNEL=scan."""
    S0 = MHDFlow(N, np.complex64).random_initial(lmax=10, seed=42)
    F0 = band_forcing(N, np.complex64, device, S0[0])
    F = torch.stack([F0, 0.1 * F0])
    St = torch.from_numpy(S0).to(device)
    z = torch.zeros_like(St)
    dt = 0.25 * hbar(N)
    with kernel_variable("scan"):
        def runner(n, solver=None):
            return build_mhd_step_fn(
                N, dt, steps=n, maxit=maxit, dtype=np.complex64,
                forcing=lambda P, S: F,
                strang_splitting=("heat", {"nu": 1e-4}), device=device,
                solver=solver)

        runner(1)(St, z, z)
        fn = runner(steps)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        S = fn(St, z, z)[0]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
    if counts != {"shear_thomas": 0, "shear_scan": steps * (maxit + 2)}:
        raise AssertionError(f"launches {counts}, expected "
                             f"{steps * (maxit + 2)} of shear_scan only")
    if S.shape != (2, N, N) or not finite(S):
        raise AssertionError(f"bad state {S.shape}")
    Sk = runner(compare_steps, shear_scan)(St, z, z)[0]
    Sp = runner(compare_steps, shear_scan_reference)(St, z, z)[0]
    step_rel = ratio(Sk, Sp)
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")
    return dict(N=N, steps=steps, maxit=maxit, launches=counts,
                kernel_vs_plain_steps=compare_steps, kernel_vs_plain=step_rel,
                stepper_steps_per_s=steps / sec)


class HostCopies:
    """Counts the calls of ``Tensor.cpu``, ``.numpy``, ``.item`` and
    ``.tolist`` while installed: each copies a tensor to the host."""

    NAMES = ("cpu", "numpy", "item", "tolist")

    def __init__(self):
        self.calls = dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        self._saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        for name, method in self._saved.items():
            def counted(t, *a, _name=name, _method=method, **kw):
                self.calls[_name] += 1
                return _method(t, *a, **kw)
            setattr(torch.Tensor, name, counted)
        return self

    def __exit__(self, *exc):
        for name, method in self._saved.items():
            setattr(torch.Tensor, name, method)


def solve_on_card(device, N=1024, steps=100, steps_out=20, maxit=5):
    """Phase 14f: ``solve`` of a card tensor through ``IsompTorch``."""
    W0 = EulerFlow(N, np.complex64).random_initial(lmax=10, seed=42)
    Wt = torch.from_numpy(W0).to(device)
    integrator = IsompTorch(maxit=maxit, dtype=np.complex64)
    integrator(Wt, 0.25 * hbar(N), steps=steps_out)  # first call: set-up
    torch.cuda.synchronize()
    reset_counts()
    with HostCopies() as copies:
        t0 = time.perf_counter()
        W = solve(Wt, stepsize=0.25, steps=steps, steps_out=steps_out,
                  integrator=integrator, progress_bar=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    counts = read_counts()
    if not isinstance(W, torch.Tensor) or W.device != Wt.device:
        raise AssertionError(f"solve returned {type(W)}")
    if any(copies.calls.values()):
        raise AssertionError(f"host copies of tensors: {copies.calls}")
    if counts != {"shear_thomas": steps * maxit, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}")
    if W.dtype != torch.complex64 or not finite(W):
        raise AssertionError(f"bad state {W.dtype}")
    return dict(N=N, steps=steps, maxit=maxit, launches=counts,
                host_copies=copies.calls, solve_steps_per_s=steps / sec)


def profiled(fn, st, steps=20, solve="shear_thomas", top=0):
    """One call of ``steps`` steps under torch.profiler: the card's ms a
    step (the kernels' own time, summed), the column solve's ms a step,
    the host-clock ms a step of the profiled call and, with ``top``, the
    ``top`` kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = solve_us = 0.0
    by_name = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # an operator's entry repeats its kernels' time
        t = e.self_device_time_total
        device_us += t
        if solve in e.key:
            solve_us += t
        if t > 0:
            by_name.append((t, e.count, e.key))
    row = {"device_ms": device_us / (1e3 * steps),
           f"{solve}_ms": solve_us / (1e3 * steps),
           "wall_ms_profiled": wall * 1e3 / steps}
    if top:
        row["kernels"] = [dict(name=key[:72], ms_a_step=t / (1e3 * steps),
                               calls_a_step=n / steps)
                          for t, n, key in sorted(by_name, reverse=True)[:top]]
    return row


def euler_members(N, B, dtype, seed=42):
    """B EulerFlow initial states (seeds seed, ..., seed + B - 1), stacked
    (B, N, N)."""
    return np.stack([EulerFlow(N, dtype).random_initial(lmax=10, seed=seed + b)
                     for b in range(B)])


class Recorded:
    """A column solve that records the ensemble size (the product of the
    leading axes) of each call, then calls ``solver``."""

    def __init__(self, solver):
        self.solver, self.batches = solver, []

    def __call__(self, w, binv, u, d):
        self.batches.append(int(np.prod(d.shape[:-2])))
        return self.solver(w, binv, u, d)


def ensemble_euler(device, N=1024, Bs=(1, 4, 16), steps_out=20, calls=2,
                   maxit=5, compare_steps=10, out=None):
    """Phase 15a-b: the batched Euler stepper, complex64, at each ensemble
    size B (members: EulerFlow initial data of seeds 42, 43, ...): launches
    (steps x maxit whatever B), per-state steps/s, and from one profiled
    call the card's ms a step and its idle share; then every member of the
    largest ensemble against its own unbatched run.  ``out`` gets the
    largest run's initial and final states (phase 16b's reference)."""
    dt = 0.25 * hbar(N)
    steps = steps_out * calls
    members = torch.from_numpy(euler_members(N, max(Bs), np.complex64)).to(
        device)
    rows = []
    for B in Bs:
        W0 = members[:B].contiguous()
        z = torch.zeros_like(W0)
        fn = build_step_fn(N, dt, steps=steps_out, maxit=maxit,
                           dtype=np.complex64, batched=True, device=device)
        fn(W0, z, z)  # first call: allocations, cuBLAS set-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = (W0, z, z)
        for _ in range(calls):
            st = fn(*st)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        if counts != {"shear_thomas": steps * maxit, "shear_scan": 0}:
            raise AssertionError(f"B={B}: launches {counts}, expected "
                                 f"{steps * maxit} of shear_thomas only")
        if st[0].shape != (B, N, N) or not finite(st[0]):
            raise AssertionError(f"B={B}: bad state {st[0].shape}")
        prof = profiled(fn, (W0, z, z), steps=steps_out)
        wall_ms = sec * 1e3 / steps
        rows.append(dict(
            B=B, steps=steps, launches=counts["shear_thomas"],
            steps_per_s=steps / sec, state_steps_per_s=B * steps / sec,
            wall_ms_a_step=wall_ms, device_ms_a_step=prof["device_ms"],
            shear_thomas_ms_a_step=prof["shear_thomas_ms"],
            idle_share=1.0 - prof["device_ms"] / wall_ms))
        if out is not None and B == max(Bs):
            out.update(W0=W0, W=st[0], launches=counts["shear_thomas"],
                       steps_out=steps_out, calls=calls, maxit=maxit)

    # each member of the largest ensemble against its own run; the
    # tolerance, stated before the first run: 1e-5 of max|W| (complex64;
    # the batched and the single GEMMs may round apart)
    B = max(Bs)
    z = torch.zeros_like(members)
    WB = build_step_fn(N, dt, steps=compare_steps, maxit=maxit,
                       dtype=np.complex64, batched=True, device=device)(
        members, z, z)[0]
    one = build_step_fn(N, dt, steps=compare_steps, maxit=maxit,
                        dtype=np.complex64, device=device)
    worst = max(ratio(WB[b], one(members[b], z[b], z[b])[0])
                for b in range(B))
    if not worst <= 1e-5:
        raise AssertionError(f"member vs its own run over {compare_steps} "
                             f"steps: {worst:.3e} > 1e-5")
    return dict(N=N, maxit=maxit, dtype="complex64", by_B=rows,
                members_vs_own_runs_steps=compare_steps,
                members_vs_own_runs=worst)


def ensemble_c128(device, N=512, B=8, steps=200, steps_out=50, maxit=5):
    """Phase 15c: the batched Euler stepper, complex128, B members, 200
    steps: tr(W^2), tr(W^3) drift <= 1e-10 on every member."""
    W0 = torch.from_numpy(euler_members(N, B, np.complex128)).to(device)
    c0 = casimirs(W0)
    z = torch.zeros_like(W0)
    fn = build_step_fn(N, 0.25 * hbar(N), steps=steps_out, maxit=maxit,
                       dtype=np.complex128, batched=True, device=device)
    reset_counts()
    t0 = time.perf_counter()
    st = (W0, z, z)
    for _ in range(steps // steps_out):
        st = fn(*st)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    if counts != {"shear_thomas": steps * maxit, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}")
    if not finite(st[0]):
        raise AssertionError("non-finite state")
    drift = np.abs(casimirs(st[0]) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(W^2), tr(W^3) by member "
                             f"{drift.tolist()} > 1e-10")
    return dict(N=N, B=B, steps=steps, maxit=maxit, launches=counts,
                max_tr_W2_drift=drift[:, 0].max(),
                max_tr_W3_drift=drift[:, 1].max(),
                state_steps_per_s=B * steps / sec)


def ensemble_mhd(device, N=1024, B=4, steps=20, maxit=5, compare_steps=5):
    """Phase 15d: the batched MHD stepper, complex64, with the named heat
    Strang splitting, under QUFLOW_PALLAS_KERNEL=scan: one launch of B
    an iteration and one of 2 B a Strang half-step."""
    S0 = torch.from_numpy(np.stack([
        MHDFlow(N, np.complex64).random_initial(lmax=10, seed=42 + b)
        for b in range(B)])).to(device)
    z = torch.zeros_like(S0)
    dt = 0.25 * hbar(N)
    with kernel_variable("scan"):
        def runner(n, solver):
            return build_mhd_step_fn(
                N, dt, steps=n, maxit=maxit, dtype=np.complex64,
                batched=True, strang_splitting=("heat", {"nu": 1e-4}),
                device=device, solver=solver)

        solver = Recorded(stepper.column_solver())
        fn = runner(steps, solver)
        fn(S0, z, z)  # first call: host factors, cuBLAS set-up
        torch.cuda.synchronize()
        solver.batches.clear()
        reset_counts()
        t0 = time.perf_counter()
        S = fn(S0, z, z)[0]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
    expected = [2 * B] + [B] * maxit + [2 * B]
    if (counts != {"shear_thomas": 0, "shear_scan": steps * (maxit + 2)}
            or solver.batches != expected * steps):
        raise AssertionError(f"launches {counts}, ensemble sizes "
                             f"{sorted(set(solver.batches))}")
    if S.shape != (B, 2, N, N) or not finite(S):
        raise AssertionError(f"bad state {S.shape}")
    Sk = runner(compare_steps, shear_scan)(S0, z, z)[0]
    Sp = runner(compare_steps, shear_scan_reference)(S0, z, z)[0]
    step_rel = ratio(Sk, Sp)
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")
    return dict(N=N, B=B, steps=steps, maxit=maxit, launches=counts,
                launches_of_B=solver.batches.count(B),
                launches_of_2B=solver.batches.count(2 * B),
                kernel_vs_plain_steps=compare_steps, kernel_vs_plain=step_rel,
                state_steps_per_s=B * steps / sec)


def checkpoint_restart(device, N=1024, steps=20, maxit=5):
    """Phase 16a: ``IsompTorch(warm=False)`` (each call a pure function of
    the state), complex64, two calls of ``steps`` against one call, a
    checkpoint saved and loaded, and the second call: bit-equal."""
    from quflow_tpu_torch.parallel.distributed import (
        load_checkpoint,
        save_checkpoint,
    )

    W0 = torch.from_numpy(EulerFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    integ = IsompTorch(maxit=maxit, dtype=np.complex64, device=device,
                       warm=False)
    dt = 0.25 * hbar(N)
    reset_counts()
    straight = integ(integ(W0, dt, steps=steps), dt, steps=steps)
    with tempfile.TemporaryDirectory() as tmp:
        half = integ(W0, dt, steps=steps)
        path = save_checkpoint(tmp, (half,), step=steps)
        (back,) = load_checkpoint(tmp, (half,), step=steps)
        resumed = integ(back, dt, steps=steps)
    counts = read_counts()
    if counts != {"shear_thomas": 4 * steps * maxit, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}")
    if back.device != W0.device or not torch.equal(resumed, straight):
        raise AssertionError("the restart through the checkpoint is not "
                             "bit-equal to the run without it")
    return dict(N=N, steps=f"{steps} + {steps}", maxit=maxit,
                checkpoint=os.path.basename(path), launches=counts,
                bit_equal=True)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_dp(device, ensemble, backend=None, tol_steps=5, tol=1e-6,
            maxit=10):
    """Phase 16b: a one-rank process group (NCCL on the card) through
    ``initialize`` and ``global_mesh``: the dp ensemble of phase 15's
    largest run, bit-equal to it with the same launches; then an adaptive
    run on the mesh, whose exit reads an all_reduce of the residual an
    iteration, against the same run without the mesh."""
    import torch.distributed as dist

    from quflow_tpu_torch.parallel.distributed import global_mesh, initialize

    if not initialize(init_method=f"tcp://localhost:{free_port()}",
                      world_size=1, rank=0, backend=backend):
        raise AssertionError("the process group did not come up")
    try:
        mesh = global_mesh()
        name = dist.get_backend()
        if mesh.shape != {"dp": 1, "tp": 1}:
            raise AssertionError(f"mesh {mesh!r}")
        W0 = ensemble["W0"]
        N = W0.shape[-1]
        dt = 0.25 * hbar(N)
        z = torch.zeros_like(W0)
        fn = build_step_fn(N, dt, steps=ensemble["steps_out"],
                           maxit=ensemble["maxit"], dtype=np.complex64,
                           batched=True, mesh=mesh, device=device)
        reset_counts()
        st = (W0, z, z)
        for _ in range(ensemble["calls"]):
            st = fn(*st)
        counts = read_counts()
        if counts["shear_thomas"] != ensemble["launches"]:
            raise AssertionError(f"launches {counts}, phase 15: "
                                 f"{ensemble['launches']}")
        if not torch.equal(st[0], ensemble["W"]):
            raise AssertionError("the dp run is not bit-equal to phase 15's")
        reductions = []
        reduce_max = mesh.max

        def counted(value, dev):
            reductions.append(value)
            return reduce_max(value, dev)

        mesh.max = counted
        kw = dict(steps=tol_steps, maxit=maxit, tol=tol, dtype=np.complex64,
                  batched=True, device=device)
        on = build_step_fn(N, dt, mesh=mesh, **kw)(W0, z, z)
        off = build_step_fn(N, dt, **kw)(W0, z, z)
        if not (torch.equal(on[0], off[0]) and torch.equal(on[3], off[3])):
            raise AssertionError("the adaptive run on the mesh differs from "
                                 "the run without it")
        if len(reductions) != int(on[3].sum()):
            raise AssertionError(f"{len(reductions)} all_reduces for "
                                 f"{int(on[3].sum())} iterations")
    finally:
        dist.destroy_process_group()
    return dict(backend=name, mesh=mesh.shape, B=W0.shape[0],
                launches=counts, bit_equal_to_phase_15=True,
                adaptive_iterations=on[3].tolist(),
                all_reduces=len(reductions))


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; "
                 "this script needs a CUDA device")
    device = torch.device("cuda", 0)
    # phases 3-5, 10, 12, 13 and 14a, c, d, f hold shear_thomas, the
    # default column solve; phases 7, 11, 14b and 14e set the variable for
    # themselves
    os.environ.pop("QUFLOW_PALLAS_KERNEL", None)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    libs = cuda_build.build_all([cuda_solve.LIBRARY, cuda_scan_solve.LIBRARY])
    report = " ;; ".join(
        f"{lib.name}: {ptxas_summary(lib.with_suffix('.log').read_text())}"
        for lib in libs)
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s, "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"ptxas: {report}", flush=True)

    rows = kernel_vs_plain(device)
    print("phase 3 kernel vs plain: " + json.dumps(rows), flush=True)

    c64 = main_path_c64(device)
    print("phase 4 main path c64: " + json.dumps(c64), flush=True)

    c128 = main_path_c128(device)
    print("phase 5 main path c128: " + json.dumps(c128), flush=True)

    scan_rows = kernel_vs_plain(device, kernel=shear_scan,
                                plain=shear_scan_reference,
                                against=shear_thomas)
    print("phase 6 scan kernel vs plain: " + json.dumps(scan_rows), flush=True)
    ragged = ragged_bit_equal(device, shear_scan, shear_scan_reference)
    print("phase 6 scan kernel vs plain, ragged: " + json.dumps(ragged),
          flush=True)

    m64 = mhd_c64(device)
    print("phase 7 MHD c64: " + json.dumps(m64), flush=True)

    m128 = mhd_c128(device)
    print("phase 8 MHD c128: " + json.dumps(m128), flush=True)

    big = mhd_large(device)
    print("phase 9 MHD c64 N=4096: " + json.dumps(big), flush=True)

    gate = {}
    ref = reference_euler(device, gate_out=gate)
    print("phase 10 reference Euler c128 N=1024: " + json.dumps(ref),
          flush=True)

    qg = reference_qg(device)
    print("phase 11 reference QG c64 N=1024, scan: " + json.dumps(qg),
          flush=True)

    fam = poisson_family(device)
    print("phase 12 Poisson family N=1024: " + json.dumps(fam), flush=True)

    rmhd = reference_mhd(device)
    print("phase 13 reference MHD c128 N=512: " + json.dumps(rmhd),
          flush=True)

    hq = hooked_qg(device)
    hq["phase_4_stepper_steps_per_s"] = c64["stepper_steps_per_s"]
    print("phase 14a hooked QG c64 N=1024: " + json.dumps(hq), flush=True)
    with kernel_variable("scan"):
        hq_scan = hooked_qg(device, shear_scan, shear_scan_reference,
                            steps=20, steps_out=20)
    print("phase 14b hooked QG c64 N=1024, scan: " + json.dumps(hq_scan),
          flush=True)
    hvr = hooked_vs_reference(device)
    print("phase 14c hooked QG c128 N=512 vs isomp: " + json.dumps(hvr),
          flush=True)
    ad = adaptive_euler(device, gate)
    print("phase 14d adaptive tol Euler c128 N=1024: " + json.dumps(ad),
          flush=True)
    hm = hooked_mhd(device)
    print("phase 14e hooked MHD c64 N=1024, scan: " + json.dumps(hm),
          flush=True)
    card = solve_on_card(device)
    card["phase_4_solve_steps_per_s"] = c64["solve_steps_per_s"]
    print("phase 14f solve of a card tensor c64 N=1024: " + json.dumps(card),
          flush=True)

    ensemble = {}
    ens = ensemble_euler(device, out=ensemble)
    print("phase 15a-b ensembles Euler c64 N=1024: " + json.dumps(ens),
          flush=True)
    ens128 = ensemble_c128(device)
    print("phase 15c ensemble Euler c128 N=512: " + json.dumps(ens128),
          flush=True)
    ens_mhd = ensemble_mhd(device)
    print("phase 15d ensemble MHD c64 N=1024, scan: " + json.dumps(ens_mhd),
          flush=True)
    # the kernels at the ensemble sizes of these paths that phases 3 and 6
    # do not time: shear_thomas at B=16, shear_scan at B=2 (phase 14e's
    # Strang launch)
    ens_rows = kernel_vs_plain(device, Ns=(1024,), Bs=(16,))
    scan_b2 = kernel_vs_plain(device, Ns=(1024,), Bs=(2,), kernel=shear_scan,
                              plain=shear_scan_reference)
    print("phase 15e kernels at B=16 (thomas) and B=2 (scan): "
          + json.dumps(ens_rows + scan_b2), flush=True)

    ckpt = checkpoint_restart(device)
    print("phase 16a checkpoint restart c64 N=1024: " + json.dumps(ckpt),
          flush=True)
    dp = nccl_dp(device, ensemble)
    print("phase 16b one-rank NCCL dp ensemble: " + json.dumps(dp),
          flush=True)

    def main_row(rows):
        return next(r for r in rows if r["dtype"] == "complex64"
                    and r["N"] == 1024 and r["B"] == 1)

    def timing(rows):
        row = main_row(rows)
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    print(json.dumps({"kernels": [{
        "name": "shear_thomas",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/shear_thomas.cu",
        "replaces": "quflow_tpu/ops/pallas_solve.py:168",
        "launches": c64["launches"],
        "launches_by_path": {
            "euler_c64_N1024": c64["launches"],
            "euler_c128_N512": c128["launches"]["shear_thomas"],
            "reference_euler_c128_N1024": ref["launches"],
            "reference_euler_c128_N1024_gate": ref["gate_launches"],
            "poisson_family_N1024": fam["launches"],
            "reference_mhd_c128_N512": rmhd["launches"],
            "hooked_qg_c64_N1024": hq["launches"]["shear_thomas"],
            "hooked_qg_c128_N512": hvr["stepper_launches"],
            "adaptive_euler_c128_N1024": ad["launches"],
            "solve_card_tensor_c64_N1024": card["launches"]["shear_thomas"],
            **{f"ensemble_euler_c64_N1024_B{r['B']}": r["launches"]
               for r in ens["by_B"]},
            "ensemble_euler_c128_N512_B8":
                ens128["launches"]["shear_thomas"],
            "checkpoint_restart_c64_N1024": ckpt["launches"]["shear_thomas"],
            "nccl_dp_euler_c64_N1024_B16": dp["launches"]["shear_thomas"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows + ens_rows),
        **timing(rows),
        "library_ms": None,
    }, {
        "name": "shear_scan",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/shear_scan.cu",
        "replaces": "quflow_tpu/ops/pallas_scan_solve.py:114",
        "launches": m64["integrator_launches"]["shear_scan"],
        "launches_by_path": {
            "mhd_c64_N1024": m64["integrator_launches"]["shear_scan"],
            "mhd_c64_N1024_logs": m64["log_launches"]["shear_scan"],
            "mhd_c128_N512": m128["launches"]["shear_scan"],
            "mhd_c64_N4096": big["launches"]["shear_scan"],
            "reference_qg_c64_N1024": qg["launches"]["shear_scan"],
            "hooked_qg_c64_N1024": hq_scan["launches"]["shear_scan"],
            "hooked_mhd_c64_N1024": hm["launches"]["shear_scan"],
            "ensemble_mhd_c64_N1024_B4": ens_mhd["launches"]["shear_scan"]},
        "max_abs_err": max(r["max_abs_err"]
                           for r in scan_rows + ragged + scan_b2),
        **timing(scan_rows),
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
