#!/usr/bin/env python3
"""Smoke test of quflow_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA device, nvcc, and nothing
of JAX.  Five phases, one line each; any failure ends the run with a
nonzero exit code and no result line.

1. device  - the card's name and power limit, as nvidia-smi reports them;
2. build   - nvcc builds csrc/shear_thomas.cu for sm_90a (seconds, ptxas
             register counts);
3. kernel  - ``shear_thomas`` against its plain PyTorch version on the card
             at N in {512, 1024, 4096} (the two main-path shapes and a large
             one), batch in {1, 4}, complex64 and complex128:
             max relative error <= 1e-5 (complex64) and <= 1e-12
             (complex128); CUDA-event times of both;
4. main path, complex64, N=1024 - EulerFlow initial data, ``solve`` with
             ``IsompTorch(maxit=5)``, 100 steps, energy/enstrophy logged
             every 20: the kernel launched exactly steps x maxit times plus
             once per energy log, enstrophy drift <= 1e-4, and a 10-step run
             through the kernel equal to one through the plain solve to
             <= 1e-5 relative; steps/s;
5. main path, complex128, N=512, 200 steps - relative drift of tr(W^2) and
             tr(W^3) <= 1e-10; steps/s.

Then a JSON line of the kernels (name, source, the TPU kernel it replaces,
launches on the main path, error and times) and, last, the result line
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from quflow_tpu_torch import energy_euler, enstrophy, hbar, solve
from quflow_tpu_torch.models import EulerFlow
from quflow_tpu_torch.ops import cuda_solve
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.parallel.stepper import (
    IsompTorch,
    _real_factors,
    build_step_fn,
)

GATE = {torch.complex64: 1e-5, torch.complex128: 1e-12}


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


def kernel_vs_plain(device, Ns=(512, 1024, 4096), Bs=(1, 4), reps=20,
                    plain_reps=2):
    """Phase 3: one row per (dtype, N, B)."""
    rows = []
    for dtype in (torch.complex64, torch.complex128):
        for N in Ns:
            w, binv, u = _real_factors(N, dtype, device=device)
            for B in Bs:
                g = torch.Generator(device=device).manual_seed(1000 * N + B)
                d = torch.randn(B, N, N + 1, dtype=dtype, device=device,
                                generator=g)
                x = shear_thomas(w, binv, u, d)
                ref = shear_thomas_reference(w, binv, u, d)
                abs_err = (x - ref).abs().max().item()
                rel_err = abs_err / ref.abs().max().item()
                if not rel_err <= GATE[dtype]:
                    raise AssertionError(
                        f"shear_thomas {dtype} N={N} B={B}: relative error "
                        f"{rel_err:.3e} > {GATE[dtype]:.0e}")
                rows.append(dict(
                    dtype=str(dtype).removeprefix("torch."), N=N, B=B,
                    max_abs_err=abs_err, max_rel_err=rel_err,
                    ms=cuda_ms(lambda: shear_thomas(w, binv, u, d), reps),
                    plain_ms=cuda_ms(
                        lambda: shear_thomas_reference(w, binv, u, d),
                        plain_reps)))
    return rows


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
    integrator = IsompTorch(maxit=maxit, dtype=np.complex64, device=device)
    log = Logger()
    shear_thomas.launches = 0
    log(W0)
    t0 = time.perf_counter()
    W = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps_out,
              integrator=integrator, callback=log, progress_bar=False)
    solve_s = time.perf_counter() - t0
    launches = shear_thomas.launches
    expected = steps * maxit + len(log.rows)
    if launches != expected:
        raise AssertionError(f"shear_thomas launched {launches} times on the "
                             f"main path, expected {expected}")
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
    t0 = time.perf_counter()
    W = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps,
              integrator=IsompTorch(maxit=maxit, dtype=np.complex128,
                                    device=device), progress_bar=False)
    sec = time.perf_counter() - t0
    if not np.isfinite(W).all():
        raise AssertionError("non-finite state")
    drift = np.abs(casimirs(torch.from_numpy(W).to(device)) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(W^2), tr(W^3) = {drift} > 1e-10")
    return dict(N=N, steps=steps, maxit=maxit, tr_W2_drift=drift[0],
                tr_W3_drift=drift[1], solve_steps_per_s=steps / sec)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; "
                 "this script needs a CUDA device")
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    lib = cuda_solve.build()
    regs = [ln.split(":", 1)[1].strip()
            for ln in lib.with_suffix(".log").read_text().splitlines()
            if "registers" in ln]
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s, {lib.name}, "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"ptxas: {' | '.join(regs)}", flush=True)

    rows = kernel_vs_plain(device)
    print("phase 3 kernel vs plain: " + json.dumps(rows), flush=True)

    c64 = main_path_c64(device)
    print("phase 4 main path c64: " + json.dumps(c64), flush=True)

    c128 = main_path_c128(device)
    print("phase 5 main path c128: " + json.dumps(c128), flush=True)

    main_row = next(r for r in rows if r["dtype"] == "complex64"
                    and r["N"] == 1024 and r["B"] == 1)
    print(json.dumps({"kernels": [{
        "name": "shear_thomas",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/shear_thomas.cu",
        "replaces": "quflow_tpu/ops/pallas_solve.py:167",
        "launches": c64["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
