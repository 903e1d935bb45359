"""The port's column solves on one CUDA card: kernel times, bounds, the
scan-versus-Thomas sweep, and the wall and device time of the Euler and MHD
steps and of the reference-semantics loop.

    python3 benchmarks/torch_column_solve.py [--against OTHER.cu]
        [--against-rule MIN,MAX] [--phases P,...]

``--against`` names another build of ``shear_thomas.cu`` or of
``shear_scan.cu`` (say a parent commit's, from ``git show``); which of the
two it is is read from the symbols it exports.  A ``shear_scan.cu`` that
was written for another chunk rule gets its rows per chunk from
``--against-rule``: max(MIN, ceil(N / MAX)) (``8,32`` for the rule before
the kernel kept its panel in shared memory).

Phases, each printed as JSON lines:

- ``check``: each kernel (with ``--against``: that kernel and its other
  build) against its plain version at ragged shapes, both dtypes:
  bit-equal; for the scan also the relative error against a complex128
  Thomas solve, which is what two chunk rules are compared on;
- ``time``: each kernel (with ``--against``: that one) at N in {512, 1024,
  2048, 4096}, batch in {1, 4, 8}, both dtypes, by CUDA-graph replay
  (chip_smoke.graph_ms), with its bound and share; the other build timed
  in turns other, this, this, other;
- ``sweep``: ``shear_scan`` against ``shear_thomas``, N in {512, ..., 4096},
  batch in {1, 2, 4, 8}, in turns thomas, scan, scan, thomas;
- ``steps``: the Euler stepper (20 steps a call, maxit 5) at N=1024
  complex64 and N=512 complex128: ms a step on the host clock, six
  readings of each ``shear_thomas`` build in turns, and one call under
  torch.profiler for the card's time a step and the kernel's share of it;
- ``mhd``: the MHD stepper through ``shear_scan`` (maxit 5) at N=1024 and
  N=4096 complex64: ms a step on the host clock, and one call under
  torch.profiler: the card's time a step by kernel name, and the share of
  the step the card idles;
- ``reference``: the reference-semantics loop, one host sync a
  fixed-point iteration: ``EulerFlow(1024).step`` (``isomp``, tol 'auto',
  maxit 10) and ``MHDFlow(512).step`` (``magmp``, tol 1e-12, maxit 20),
  complex128, 20 steps a call: ms a step on the host clock, iterations a
  step, and one call under torch.profiler as in ``mhd``;
- ``hooks``: the forced-dissipative QG step of chip_smoke.py phase 14a
  (N=1024 complex64, maxit 5, timed forcing, viscdamp Strang with
  theta 0.5; 20 steps a call): ms a step on the host clock, one call under
  torch.profiler (the card's ms a step by kernel name, the idle share),
  the card's ms of the step's two Strang half-steps and of their two
  theta-scheme right-hand sides (the bare shear Laplacian) each run
  alone, and their shares of the step; beside it the same QG step with
  no hooks;
- ``large``: ``shear_scan`` and ``shear_thomas`` at N=8192, B=1, complex64
  (128 chunks, the most a column can have): each one's relative error
  against a complex128 Thomas solve (the scan's at most 3 times the
  other's) and both times; not run unless asked for.

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
from quflow_tpu_torch.models import EulerFlow, GlobalQGFlow, MHDFlow  # noqa: E402
from quflow_tpu_torch.ops import cuda_build, cuda_scan_solve, cuda_solve  # noqa: E402
from quflow_tpu_torch.ops.cuda_solve import (  # noqa: E402
    launch_solve,
    shear_thomas,
    shear_thomas_reference,
)
from quflow_tpu_torch.ops.cuda_scan_solve import (  # noqa: E402
    chunk_rows,
    shear_scan,
    shear_scan_reference,
)
from quflow_tpu_torch.parallel import stepper  # noqa: E402
from quflow_tpu_torch.parallel.stepper import (  # noqa: E402
    _real_factors,
    build_mhd_step_fn,
    build_step_fn,
)

DTYPES = (torch.complex64, torch.complex128)
KERNELS = {"shear_thomas": (shear_thomas, shear_thomas_reference),
           "shear_scan": (shear_scan, shear_scan_reference)}
RAGGED = ((1, 1), (2, 3), (7, 2), (100, 1), (100, 3), (257, 1), (257, 3),
          (1000, 1), (1000, 3), (1024, 1), (1024, 3), (513, 9), (64, 20),
          (2047, 2), (4100, 1))


def data(N, B, dtype, device):
    w, binv, u = _real_factors(N, dtype, device=device)
    g = torch.Generator(device=device).manual_seed(1000 * N + B)
    return w, binv, u, torch.randn(B, N, N + 1, dtype=dtype, device=device,
                                   generator=g)


def in_turns(a, b, reps=20):
    """Graph-replay ms of ``a`` and ``b`` read a, b, b, a."""
    t = [chip_smoke.graph_ms(f, reps) for f in (a, b, b, a)]
    return t, (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def truth(w, binv, u, d):
    """The Thomas solve in complex128, whatever the dtype of the input."""
    return shear_thomas(w.double(), binv.double(), u.double(),
                        d.to(torch.complex128))


def check(device, names, other):
    bad = []
    for name in names:
        kernel, plain = KERNELS[name]
        for dtype in DTYPES:
            for N, B in RAGGED:
                w, binv, u, d = data(N, B, dtype, device)
                x = kernel(w, binv, u, d)
                row = dict(phase="check", kernel=name, dtype=str(dtype)[6:],
                           N=N, B=B,
                           err=(x - plain(w, binv, u, d)).abs().max().item())
                if name == "shear_scan" or other is not None:
                    t = truth(w, binv, u, d)
                    scale = t.abs().max()
                    row["rel_err_c128"] = ((x - t).abs().max() / scale).item()
                    if other is not None:
                        row["rel_err_c128_against"] = (
                            (other(w, binv, u, d) - t).abs().max()
                            / scale).item()
                print(json.dumps(row), flush=True)
                if row["err"] != 0.0:
                    bad.append(row)
    if bad:
        raise AssertionError(f"not bit-equal: {bad}")


def timing(device, names, other):
    for name in names:
        kernel = KERNELS[name][0]
        for dtype in DTYPES:
            for N in (512, 1024, 2048, 4096):
                for B in (1, 4, 8):
                    w, binv, u, d = data(N, B, dtype, device)
                    bound, _ = chip_smoke.solve_bound(N, B, dtype)
                    new = lambda: kernel(w, binv, u, d)  # noqa: E731
                    row = dict(phase="time", kernel=name,
                               dtype=str(dtype)[6:], N=N, B=B, bound_ms=bound)
                    if name == "shear_scan":
                        row["geometry"] = cuda_scan_solve.geometry(B, N, dtype)
                    if other is None:
                        row["ms"] = chip_smoke.graph_ms(new, 20)
                    else:
                        (row["readings"], row["against_ms"],
                         row["ms"]) = in_turns(
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


def large(device, N=8192):
    w, binv, u, d = data(N, 1, torch.complex64, device)
    t = truth(w, binv, u, d)
    scale = t.abs().max()
    err = {f.__name__: ((f(w, binv, u, d) - t).abs().max() / scale).item()
           for f in (shear_scan, shear_thomas)}
    del t
    r, thomas_ms, scan_ms = in_turns(lambda: shear_thomas(w, binv, u, d),
                                     lambda: shear_scan(w, binv, u, d), reps=5)
    bound, _ = chip_smoke.solve_bound(N, 1, torch.complex64)
    print(json.dumps(dict(phase="large", N=N, B=1, dtype="complex64",
                          geometry=cuda_scan_solve.geometry(
                              1, N, torch.complex64),
                          rel_err_c128=err, thomas_ms=thomas_ms,
                          scan_ms=scan_ms, bound_ms=bound, readings=r)),
          flush=True)
    if not err["shear_scan"] <= 3 * err["shear_thomas"]:
        raise AssertionError(f"errors against complex128 at N={N}: {err}")


def step_ms(fn, st, calls=10, steps=20):
    """Host-clock ms a step of ``calls`` calls of ``steps`` steps, after
    one."""
    st = fn(*st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        st = fn(*st)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (steps * calls)


def profiled(fn, st, steps=20, solve="shear_thomas", top=0):
    """One call of ``steps`` steps under torch.profiler: the card's ms a
    step, the column solve's share of it, the host-clock ms a step and,
    with ``top``, the ``top`` kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def mhd(device):
    for N, n, calls in ((1024, 20, 5), (4096, 2, 2)):
        S0 = torch.from_numpy(MHDFlow(N, np.complex64).random_initial(
            lmax=10, seed=42)).to(device)
        z = torch.zeros_like(S0)
        fn = build_mhd_step_fn(N, 0.25 * hbar(N), steps=n, maxit=5,
                               dtype=np.complex64, device=device,
                               solver=shear_scan)
        readings = [step_ms(fn, (S0, z, z), calls=calls, steps=n)
                    for _ in range(3)]
        row = dict(phase="mhd", N=N, dtype="complex64", steps_a_call=n,
                   ms_a_step=readings, median_ms=float(np.median(readings)),
                   **profiled(fn, (S0, z, z), steps=n, solve="shear_scan",
                              top=14))
        row["idle_share"] = 1 - row["device_ms"] / row["median_ms"]
        print(json.dumps(row), flush=True)
        del S0, z, fn


def reference(device, steps=20):
    for name, flow, kwargs in (
            ("isomp", EulerFlow(1024), {}),
            ("magmp", MHDFlow(512), dict(tol=1e-12, maxit=20))):
        N = flow.N
        S0 = torch.from_numpy(flow.random_initial(lmax=10, seed=42)).to(device)
        dt = 0.25 * hbar(N)
        stats = {}

        def fn(S):
            return (flow.step(S, dt, steps=steps, stats=stats, **kwargs),)

        readings = [step_ms(fn, (S0,), calls=3, steps=steps) for _ in range(3)]
        row = dict(phase="reference", integrator=name, N=N, dtype="complex128",
                   tol=kwargs.get("tol", "auto"), ms_a_step=readings,
                   median_ms=float(np.median(readings)),
                   iterations_a_step=stats["iterations"],
                   **profiled(fn, (S0,), steps=steps, top=12))
        row["idle_share"] = 1 - row["device_ms"] / row["median_ms"]
        print(json.dumps(row), flush=True)


def hooks(device, N=1024, n=20):
    flow = GlobalQGFlow(N, np.complex64, gamma=chip_smoke.QG_GAMMA)
    W0 = flow.random_initial(lmax=10, seed=42)
    forcing = chip_smoke.qg_forcing(chip_smoke.band_forcing(
        N, np.complex64, device, W0))
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)
    timed = flow.stepper(dt, n, maxit=5, forcing=forcing,
                         strang_splitting=chip_smoke.VISCDAMP, device=device)

    def fn(W, dW, csum):
        return timed(W, dW, csum, 0.0)

    row = dict(phase="hooks", N=N, dtype="complex64", steps_a_call=n)
    for name, run in (("hooked", fn),
                      ("plain_qg", flow.stepper(dt, n, maxit=5,
                                                device=device))):
        readings = [step_ms(run, (Wt, z, z), calls=5, steps=n)
                    for _ in range(3)]
        prof = profiled(run, (Wt, z, z), steps=n, top=16)
        row[name] = dict(ms_a_step=readings,
                         median_ms=float(np.median(readings)), **prof)
        row[name]["idle_share"] = 1 - prof["device_ms"] / float(
            np.median(readings))
    # the step's parts, each run alone: two Strang half-steps, and the two
    # theta-scheme right-hand sides inside them
    hook = stepper._strang_hook(chip_smoke.VISCDAMP, N, dt, np.complex64,
                                np.float32(dt / 2), device,
                                stepper.column_solver())
    _, _, theta_rhs = stepper._resolve_strang_named(chip_smoke.VISCDAMP, dt)
    cW, cL = (float(np.float32(c)) for c in theta_rhs)
    lap = stepper._mhd_lap_op(N, np.complex64, device=device)

    def rhs(W):
        return cW * W + cL * stepper._laplace_core(W, lap)

    step_ms_card = row["hooked"]["device_ms"]
    for name, part in (("strang", lambda W: (hook(hook(W)),)),
                       ("theta_rhs", lambda W: (rhs(rhs(W)),))):
        ms = profiled(part, (Wt,), steps=1)["device_ms"]
        row[f"{name}_device_ms"] = ms
        row[f"{name}_share"] = ms / step_ms_card
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path,
                    help="another shear_thomas.cu or shear_scan.cu to time "
                         "in turns")
    ap.add_argument("--against-rule", default=None, metavar="MIN,MAX",
                    help="rows per chunk of an --against shear_scan.cu: "
                         "max(MIN, ceil(N / MAX)); default: this tree's rule")
    ap.add_argument("--phases", default="check,time,sweep,steps,mhd")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_column_solve.py: no CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = [cuda_solve.LIBRARY, cuda_scan_solve.LIBRARY]
    names = list(KERNELS)
    other = None
    libraries = {}
    if args.against is not None:
        text = args.against.read_text()
        name = next(k for k in KERNELS if f"{k}_f32" in text)
        names = [name]
        n_ints = 4 if name == "shear_thomas" else 5  # the scan takes L too

        def bind(lib):
            for suffix in ("f32", "f64"):
                cuda_build.launcher_argtypes(
                    getattr(lib, f"{name}_{suffix}"), 5, n_ints)
            cuda_build.bind_error_string(getattr(lib, f"{name}_error"))

        against = cuda_build.CudaLibrary(name, bind)
        against.source = args.against.resolve()
        libs.append(against)
    paths = cuda_build.build_all(libs)
    for path in paths:
        print(json.dumps({"ptxas": path.name, "report": chip_smoke.ptxas_summary(
            path.with_suffix(".log").read_text())}), flush=True)
    if args.against is not None:
        rows = chunk_rows
        if args.against_rule:
            lo, hi = map(int, args.against_rule.split(","))
            rows = lambda N: max(lo, -(-N // hi))  # noqa: E731
        extra = (lambda N: (rows(N),)) if name == "shear_scan" else (
            lambda N: ())
        other = lambda w, binv, u, d: launch_solve(  # noqa: E731
            name, against, w, binv, u, d, *extra(d.shape[-2]))
        if name == "shear_thomas":
            libraries = {"against": against.load()}
    libraries["this"] = cuda_solve.LIBRARY.load()
    for phase in args.phases.split(","):
        t0 = time.perf_counter()
        {"check": lambda: check(device, names, other),
         "time": lambda: timing(device, names, other),
         "sweep": lambda: sweep(device),
         "steps": lambda: steps(device, libraries),
         "mhd": lambda: mhd(device),
         "reference": lambda: reference(device),
         "hooks": lambda: hooks(device),
         "large": lambda: large(device)}[phase]()
        print(json.dumps({"phase_seconds": phase,
                          "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
