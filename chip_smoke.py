#!/usr/bin/env python3
"""Smoke test of quflow_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA device, nvcc, and nothing
of JAX.  Nine phases, one line each; any failure ends the run with a
nonzero exit code and no result line.

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
             through ``shear_scan``: finite; launches; steps/s.

Every main path (phases 4, 5, 7, 8, 9) runs with every launch count set to
0 just before it and read just after.  Then a JSON line of the kernels
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

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from quflow_tpu_torch import energy_euler, enstrophy, hbar, solve
from quflow_tpu_torch.models import EulerFlow, MHDFlow
from quflow_tpu_torch.ops import cuda_build, cuda_scan_solve, cuda_solve
from quflow_tpu_torch.ops.cuda_scan_solve import (
    shear_scan,
    shear_scan_reference,
)
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
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
    """A plain-Python solve callback: energy and enstrophy per output."""

    def __init__(self):
        self.rows = []

    def __call__(self, W, delta_time=0.0, delta_steps=0, **stats):
        self.rows.append((float(energy_euler(W)), float(enstrophy(W))))


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
    W2 = W @ W
    return np.array([torch.diagonal(W2, dim1=-2, dim2=-1).sum().real.item(),
                     torch.diagonal(W2 @ W, dim1=-2, dim2=-1).sum().imag.item()])


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


def theta_spectrum(S, device):
    Theta = torch.from_numpy(np.asarray(S[1])).to(device, torch.complex128)
    return torch.linalg.eigvalsh(-1j * Theta)


def mhd_c64(device, N=1024, steps=100, steps_out=20, maxit=5,
            compare_steps=10):
    """Phase 7, with QUFLOW_PALLAS_KERNEL=scan set for this phase only."""
    S0 = MHDFlow(N, np.complex64).random_initial(lmax=10, seed=42)
    lam0 = theta_spectrum(S0, device)
    saved = os.environ.get("QUFLOW_PALLAS_KERNEL")
    os.environ["QUFLOW_PALLAS_KERNEL"] = "scan"
    try:
        integrator = MagmpTorch(maxit=maxit, dtype=np.complex64, device=device)
        log = MHDLogger(N, device)
        reset_counts()
        log(S0)
        t0 = time.perf_counter()
        S = solve(S0.copy(), stepsize=0.25, steps=steps, steps_out=steps_out,
                  integrator=integrator, callback=log, progress_bar=False)
        solve_s = time.perf_counter() - t0
        total = read_counts()
    finally:
        if saved is None:
            del os.environ["QUFLOW_PALLAS_KERNEL"]
        else:
            os.environ["QUFLOW_PALLAS_KERNEL"] = saved
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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; "
                 "this script needs a CUDA device")
    device = torch.device("cuda", 0)
    # phases 3-5 hold shear_thomas, the default column solve; phase 7 sets
    # the variable for itself
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
            "mhd_c64_N1024_logs": m64["log_launches"]["shear_thomas"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
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
            "mhd_c128_N512": m128["launches"]["shear_scan"],
            "mhd_c64_N4096": big["launches"]["shear_scan"]},
        "max_abs_err": max(r["max_abs_err"] for r in scan_rows + ragged),
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
