"""The column solves' real-lane entries (``shear_thomas`` and ``shear_scan``
on a real rhs: ``shear_thomas_lane_kernel`` in csrc/shear_thomas.cu,
``shear_scan_lane_kernel`` in csrc/shear_scan.cu) on one CUDA card:
bit-equality, times against their bounds and against another build, the
steps of the paths that run them, and the scan's plans.

    python3 benchmarks/torch_lane_solve.py [--against OTHER.cu]
        [--phases check,time,steps,plans] [--out FILE.jsonl]

Phases, each printed as JSON lines (and, with ``--out``, written there):

- ``check``: both entries bit-equal to their plain versions on float planes
  (B = 2, L = N+1) and on the interleaved view (B = 1, L = 2(N+1)), there
  also to the complex entry on the same bytes, both dtypes, at ragged N, on
  a d one value into its buffer and each side of the first edge of each
  launch plan above N = 1024 (chip_smoke.lane_kernels, phase 23a's set);
- ``time``: by CUDA-graph replay (chip_smoke.graph_ms), N in {512, 1024,
  2048, 4096} on float32 planes and the interleaved view, and the float64
  interleaved view at N = 512 and 1024, each beside its bound
  (chip_smoke.lane_bound), its share and its launch plan;
- ``steps``: host ms a step (calls of 20 steps, state on the card, the
  compiled runners as a user gets them) of ``build_planes_step_fn`` at
  N = 1024, pure and warm ('high_karatsuba'), and of 'shear_pallas_il'
  Euler complex64 N = 1024 and complex128 N = 512, each with
  ``shear_thomas`` and with ``shear_scan``;
- ``plans``: ``shear_scan``'s real lanes under every launch plan its
  reckoning weighs (ops/cuda_scan_solve.lane_plans), at the float32 planes
  N = 1024, 2048, 4096, the interleaved view N = 1024 and float64
  interleaved N = 512: reckoned and measured ms side by side, each launch
  bit-equal (the data the reckoning's constants are fitted to); and
  ``shear_thomas``'s at each tile of ops/cuda_solve.LANE_TILES.

``--against`` builds another source of shear_thomas.cu or shear_scan.cu
(say a parent commit's, from ``git show``) whose real-lane entry takes no
launch plan, ``(w, binv, u, d, out, B, N, L[, chunk rows], device,
stream)``; its exported symbols say which kernel it is.  ``time`` then
checks the two builds bit-equal and times them in turns, other, this,
this, other; ``steps`` runs that kernel's paths in turns the same way, the
other build's through ``solver=`` (its complex launches go to this build,
whose complex entries the two share).

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
from quflow_tpu_torch.ops.cuda_scan_solve import (  # noqa: E402
    shear_scan,
    shear_scan_reference,
)
from quflow_tpu_torch.ops.cuda_solve import (  # noqa: E402
    shear_thomas,
    shear_thomas_reference,
)
from quflow_tpu_torch.parallel import stepper  # noqa: E402
from torch_row_solve import build  # noqa: E402  (this directory)

KERNELS = {"shear_thomas": (shear_thomas, shear_thomas_reference),
           "shear_scan": (shear_scan, shear_scan_reference)}
#: phase time's shapes: (dtype, view, N)
TIMES = tuple((torch.float32, view, N) for N in (512, 1024, 2048, 4096)
              for view in ("planes", "interleaved")) + (
    (torch.float64, "interleaved", 512), (torch.float64, "interleaved", 1024))
#: phase plans' shapes
PLAN_SHAPES = ((torch.float32, "planes", 1024),
               (torch.float32, "interleaved", 1024),
               (torch.float64, "interleaved", 512),
               (torch.float32, "planes", 2048),
               (torch.float32, "planes", 4096))


def emit(out, tag, row):
    line = json.dumps({tag: row})
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def other_solver(lib):
    """(kernel name, solve) of a build whose real-lane entry takes no plan:
    a real rhs through that build, a complex one through this build's
    complex entry."""
    name = "shear_thomas" if hasattr(lib, "shear_thomas_real_f32") \
        else "shear_scan"
    extra = 4 if name == "shear_thomas" else 5
    f32, f64 = (getattr(lib, f"{name}_real_f32"),
                getattr(lib, f"{name}_real_f64"))
    for fn in (f32, f64):
        cuda_build.launcher_argtypes(fn, 5, extra)
    kernel = KERNELS[name][0]

    def solve(w, binv, u, d):
        if d.is_complex():
            return kernel(w, binv, u, d)
        N, L = d.shape[-2:]
        out = torch.empty_like(d)
        args = (d.numel() // (N * L), N, L)
        if name == "shear_scan":
            args += (cuda_scan_solve.chunk_rows(N),)
        fn = f32 if d.dtype == torch.float32 else f64
        err = fn(w.data_ptr(), binv.data_ptr(), u.data_ptr(), d.data_ptr(),
                 out.data_ptr(), *args, d.device.index or 0,
                 torch.cuda.current_stream(d.device).cuda_stream)
        if err:
            raise RuntimeError(f"the other {name} failed: cudaError_t {err}")
        return out
    return name, solve


def plan_of(name, B, N, L, dtype, index):
    if name == "shear_thomas":
        return cuda_solve.lane_plan(B, N, L, dtype,
                                    cuda_solve.sms(index))._asdict()
    return cuda_scan_solve.lane_plan(B, N, L, dtype,
                                     cuda_solve.sms(index))._asdict()


def check(device, out):
    rows = chip_smoke.lane_kernels(device)
    for row in rows:
        emit(out, "check", row)
    emit(out, "check_summary", dict(
        solves=len(rows), max_abs_err=max(r["max_abs_err"] for r in rows),
        interleaved_vs_complex=max(r.get("interleaved_vs_complex", 0.0)
                                   for r in rows)))


def timing(device, out, other, reps=20):
    index = device.index or 0
    names = [other[0]] if other else list(KERNELS)
    for name in names:
        kernel = KERNELS[name][0]
        for dtype, view, N in TIMES:
            fac, d = next((f, x) for v, f, x in
                          chip_smoke.lane_views(N, dtype, device, N)
                          if v == view)
            B, L = d.shape[0], d.shape[-1]
            bound, by = chip_smoke.lane_bound(N, L, B, dtype)
            row = dict(kernel=name + "_real", view=view, dtype=str(dtype)[6:],
                       N=N, L=L, B=B, bound_ms=bound, bound_by=by,
                       plan=plan_of(name, B, N, L, dtype, index))
            if other is None:
                row["ms"] = chip_smoke.graph_ms(lambda: kernel(*fac, d), reps)
            else:
                if not torch.equal(other[1](*fac, d), kernel(*fac, d)):
                    raise AssertionError(f"the other build differs at {row}")
                fns = {"other": lambda: other[1](*fac, d),
                       "this": lambda: kernel(*fac, d)}
                for who in ("other", "this", "this", "other"):
                    row.setdefault(f"{who}_ms", []).append(
                        chip_smoke.graph_ms(fns[who], reps))
                row["ms"] = min(row["this_ms"])
                row["speedup"] = min(row["other_ms"]) / row["ms"]
            row["share"] = bound / row["ms"]
            emit(out, "time", row)


def step_ms(call, calls=5, steps=20):
    """Host-clock ms a step of ``calls`` calls of ``steps`` steps, after
    one."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (calls * steps)


def step_paths(device, name, solver, steps=20, maxit=5):
    """{path: a call of ``steps`` steps} of the paths of kernel ``name``,
    each built with ``solver`` (None: the kernel as a user gets it)."""
    solve = solver if solver is not None else KERNELS[name][0]
    paths = {}
    N = 1024
    W0 = torch.from_numpy(EulerFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    Wp = torch.stack([W0.real, W0.imag]).contiguous()
    zp = torch.zeros_like(Wp)
    for label, kw in (("pure", {}),
                      ("warm", dict(warm_precision="high_karatsuba"))):
        fn = stepper.build_planes_step_fn(N, 0.25 * hbar(N), steps=steps,
                                          maxit=maxit, device=device,
                                          solver=solve, **kw)
        paths[f"planes_N{N}_{label}"] = (lambda fn=fn: fn(Wp, zp, zp))
    for N, dtype in ((1024, np.complex64), (512, np.complex128)):
        S0 = torch.from_numpy(EulerFlow(N, dtype).random_initial(
            lmax=10, seed=42)).to(device)
        z = torch.zeros_like(S0)
        fn = stepper.build_step_fn(N, 0.25 * hbar(N), steps=steps,
                                   maxit=maxit, dtype=dtype, device=device,
                                   layout="shear_pallas_il", solver=solve)
        paths[f"shear_pallas_il_{np.dtype(dtype).name}_N{N}"] = (
            lambda fn=fn, S0=S0, z=z: fn(S0, z, z))
    return paths


def steps(device, out, other):
    names = [other[0]] if other else list(KERNELS)
    for name in names:
        builds = {"this": step_paths(device, name, None)}
        if other:
            builds["other"] = step_paths(device, name, other[1])
        for path in builds["this"]:
            row = dict(kernel=name, path=path)
            order = ("other", "this", "this", "other") if other else \
                ("this", "this")
            for who in order:
                row.setdefault(f"{who}_ms_a_step", []).append(
                    step_ms(builds[who][path]))
            row["ms_a_step"] = float(np.median(row["this_ms_a_step"]))
            row["steps_per_s"] = 1e3 / row["ms_a_step"]
            if other:
                row["other_median_ms"] = float(np.median(
                    row["other_ms_a_step"]))
                row["speedup"] = row["other_median_ms"] / row["ms_a_step"]
            emit(out, "steps", row)


def plans(device, out, reps=10):
    index = device.index or 0
    for dtype, view, N in PLAN_SHAPES:
        fac, d = next((f, x) for v, f, x in
                      chip_smoke.lane_views(N, dtype, device, N) if v == view)
        B, L = d.shape[0], d.shape[-1]
        ref = shear_scan_reference(*fac, d)
        seen = set()
        for p in cuda_scan_solve.lane_plans(B, N, L, dtype,
                                            cuda_solve.sms(index)):
            key = (p.tile, p.cluster, p.mode, p.late)
            if key in seen:
                continue
            seen.add(key)
            args = (cuda_scan_solve.chunk_rows(N),
                    *cuda_scan_solve._plan_args(p))

            def run():
                return cuda_solve.launch_solve(
                    "shear_scan", cuda_scan_solve.LIBRARY, *fac, d, *args)
            if not torch.equal(run(), ref):
                raise AssertionError(f"shear_scan plan {p} not bit-equal")
            emit(out, "plans", dict(kernel="shear_scan_real", view=view,
                                    dtype=str(dtype)[6:], N=N,
                                    ms=chip_smoke.graph_ms(run, reps),
                                    reckoned_ms=1e3 * p.seconds,
                                    **p._asdict()))
        ref = shear_thomas_reference(*fac, d)
        for lanes in cuda_solve.LANE_TILES:
            seconds, p = cuda_solve._lane_option(B, N, L, dtype,
                                                 cuda_solve.sms(index), lanes,
                                                 False)
            args = (p.lanes, p.chunk, int(p.resident), p.shared_bytes)

            def run():
                return cuda_solve.launch_solve(
                    "shear_thomas", cuda_solve.LIBRARY, *fac, d, *args)
            if not torch.equal(run(), ref):
                raise AssertionError(f"shear_thomas plan {p} not bit-equal")
            emit(out, "plans", dict(kernel="shear_thomas_real", view=view,
                                    dtype=str(dtype)[6:], N=N,
                                    ms=chip_smoke.graph_ms(run, reps),
                                    reckoned_ms=1e3 * seconds,
                                    **p._asdict()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another build of csrc/shear_thomas.cu or "
                    "csrc/shear_scan.cu whose real-lane entry takes no "
                    "launch plan")
    ap.add_argument("--phases", default="check,time,steps,plans")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_lane_solve.py needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    cuda_build.build_all([cuda_solve.LIBRARY, cuda_scan_solve.LIBRARY])
    other = (other_solver(build("lane_other", args.against.read_text()))
             if args.against else None)
    out = args.out.open("w") if args.out else None
    phases = args.phases.split(",")
    if "check" in phases:
        check(device, out)
    if "time" in phases:
        timing(device, out, other)
    if "steps" in phases:
        steps(device, out, other)
    if "plans" in phases:
        plans(device, out)


if __name__ == "__main__":
    main()
