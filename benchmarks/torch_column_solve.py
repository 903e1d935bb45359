"""The port's column solves on one CUDA card: kernel times, bounds, the
scan-versus-Thomas sweep and the Euler step's wall and device time.

    python3 benchmarks/torch_column_solve.py [--against OTHER.cu] [--phases P,...]

Phases, each printed as JSON lines:

- ``check``: ``shear_thomas`` (and the ``--against`` build) bit-equal to
  its plain version at ragged shapes, both dtypes;
- ``time``: ``shear_thomas`` at N in {512, 1024, 2048, 4096}, batch in
  {1, 4, 8}, both dtypes, by CUDA-graph replay (chip_smoke.graph_ms), with
  its bound and share; with ``--against``, that build of another
  ``shear_thomas.cu`` (say a parent commit's, from ``git show``) timed in
  turns other, this, this, other;
- ``sweep``: ``shear_scan`` against ``shear_thomas``, N in {512, ..., 4096},
  batch in {1, 2, 4, 8}, in turns thomas, scan, scan, thomas;
- ``steps``: the Euler stepper (20 steps a call, maxit 5) at N=1024
  complex64 and N=512 complex128: ms a step on the host clock, six
  readings of each build in turns, and one call under torch.profiler for
  the card's time a step and the kernel's share of it.

Needs one CUDA card and nvcc; imports nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from quflow_tpu_torch import hbar  # noqa: E402
from quflow_tpu_torch.models import EulerFlow  # noqa: E402
from quflow_tpu_torch.ops import cuda_build, cuda_scan_solve, cuda_solve  # noqa: E402
from quflow_tpu_torch.ops.cuda_solve import (  # noqa: E402
    launch_solve,
    shear_thomas,
    shear_thomas_reference,
)
from quflow_tpu_torch.ops.cuda_scan_solve import shear_scan  # noqa: E402
from quflow_tpu_torch.parallel.stepper import _real_factors, build_step_fn  # noqa: E402

DTYPES = (torch.complex64, torch.complex128)


def data(N, B, dtype, device):
    w, binv, u = _real_factors(N, dtype, device=device)
    g = torch.Generator(device=device).manual_seed(1000 * N + B)
    return w, binv, u, torch.randn(B, N, N + 1, dtype=dtype, device=device,
                                   generator=g)


def in_turns(a, b, reps=20):
    """Graph-replay ms of ``a`` and ``b`` read a, b, b, a."""
    t = [chip_smoke.graph_ms(f, reps) for f in (a, b, b, a)]
    return t, (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def check(device, other):
    bad = []
    for dtype in DTYPES:
        for N, B in ((1, 1), (2, 3), (7, 2), (100, 1), (100, 3), (257, 1),
                     (257, 3), (1024, 1), (1024, 3), (513, 9), (64, 20)):
            w, binv, u, d = data(N, B, dtype, device)
            ref = shear_thomas_reference(w, binv, u, d)
            row = dict(phase="check", dtype=str(dtype)[6:], N=N, B=B,
                       err=(shear_thomas(w, binv, u, d) - ref).abs().max().item())
            if other is not None:
                row["err_against"] = (other(w, binv, u, d) - ref).abs().max().item()
            print(json.dumps(row), flush=True)
            if row["err"] != 0.0:
                bad.append(row)
    if bad:
        raise AssertionError(f"shear_thomas not bit-equal: {bad}")


def timing(device, other):
    for dtype in DTYPES:
        for N in (512, 1024, 2048, 4096):
            for B in (1, 4, 8):
                w, binv, u, d = data(N, B, dtype, device)
                bound, _ = chip_smoke.solve_bound(N, B, dtype)
                new = lambda: shear_thomas(w, binv, u, d)  # noqa: E731
                row = dict(phase="time", dtype=str(dtype)[6:], N=N, B=B,
                           bound_ms=bound)
                if other is None:
                    row["ms"] = chip_smoke.graph_ms(new, 20)
                else:
                    row["readings"], row["against_ms"], row["ms"] = in_turns(
                        lambda: other(w, binv, u, d), new)
                    row["speedup"] = row["against_ms"] / row["ms"]
                    row["share_against"] = bound / row["against_ms"]
                row["share"] = bound / row["ms"]
                print(json.dumps(row), flush=True)
                del d


def sweep(device):
    for dtype in DTYPES:
        for N in (512, 1024, 2048, 4096):
            for B in (1, 2, 4, 8):
                w, binv, u, d = data(N, B, dtype, device)
                t, thomas_ms, scan_ms = in_turns(
                    lambda: shear_thomas(w, binv, u, d),
                    lambda: shear_scan(w, binv, u, d))
                print(json.dumps(dict(phase="sweep", dtype=str(dtype)[6:], N=N,
                                      B=B, thomas_ms=thomas_ms,
                                      scan_ms=scan_ms, readings=t)), flush=True)
                del d


def step_ms(fn, st, calls=10):
    """Host-clock ms a step of ``calls`` calls of 20 steps, after one."""
    st = fn(*st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        st = fn(*st)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (20 * calls)


def profiled(fn, st):
    """One call of 20 steps under torch.profiler: the card's ms a step, the
    column solve's share of it, and the host-clock ms a step."""
    from torch.profiler import ProfilerActivity, profile

    fn(*st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = solve_us = 0.0
    for e in prof.key_averages():
        t = e.self_device_time_total
        device_us += t
        if "shear_thomas" in e.key:
            solve_us += t
    return dict(device_ms=device_us / 20e3, shear_thomas_ms=solve_us / 20e3,
                wall_ms_profiled=wall * 1e3 / 20)


def steps(device, libraries):
    for N, dtype in ((1024, np.complex64), (512, np.complex128)):
        W0 = torch.from_numpy(EulerFlow(N, dtype).random_initial(
            lmax=10, seed=42)).to(device)
        z = torch.zeros_like(W0)
        fn = build_step_fn(N, 0.25 * hbar(N), steps=20, maxit=5, dtype=dtype,
                           device=device)
        row = dict(phase="steps", N=N, dtype=np.dtype(dtype).name,
                   ms_a_step={k: [] for k in libraries}, profile={})
        order = list(libraries) + list(libraries)[::-1]
        for _ in range(3):
            for name in order:
                cuda_solve.LIBRARY._lib = libraries[name]
                row["ms_a_step"][name].append(step_ms(fn, (W0, z, z)))
        for name, lib in libraries.items():
            cuda_solve.LIBRARY._lib = lib
            row["profile"][name] = profiled(fn, (W0, z, z))
        cuda_solve.LIBRARY._lib = libraries["this"]
        row["median_ms"] = {k: float(np.median(v))
                            for k, v in row["ms_a_step"].items()}
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path,
                    help="another shear_thomas.cu to time in turns")
    ap.add_argument("--phases", default="check,time,sweep,steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_column_solve.py: no CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = [cuda_solve.LIBRARY, cuda_scan_solve.LIBRARY]
    if args.against is not None:
        against = cuda_build.CudaLibrary("shear_thomas", cuda_solve._bind)
        against.source = args.against.resolve()
        libs.append(against)
    paths = cuda_build.build_all(libs)
    for path in paths:
        print(json.dumps({"ptxas": path.name, "report": chip_smoke.ptxas_summary(
            path.with_suffix(".log").read_text())}), flush=True)
    other = None
    libraries = {"this": cuda_solve.LIBRARY.load()}
    if args.against is not None:
        libraries = {"against": against.load(), **libraries}
        other = lambda w, binv, u, d: launch_solve(  # noqa: E731
            "shear_thomas", against, w, binv, u, d)
    for phase in args.phases.split(","):
        t0 = time.perf_counter()
        {"check": lambda: check(device, other),
         "time": lambda: timing(device, other),
         "sweep": lambda: sweep(device),
         "steps": lambda: steps(device, libraries)}[phase]()
        print(json.dumps({"phase_seconds": phase,
                          "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
