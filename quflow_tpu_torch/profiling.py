"""Per-operation profiling of quflow_tpu_torch.

Counterpart of profiling/run_profiling.py (parity with reference
profiling/run_profiling.py:139-206): times matmul, commutator, Poisson
solve, inner product, the production isomp step (``build_step_fn``,
maxit 5, the column kernel on the card), and the host transforms shr2mat
and mat2shr, for N = 32, 64, ..., nmax (repeats ~ 2^11/N), and writes a
table to ``<basename>_<platform>_<prec>_<date>.txt``.  Runs on the CUDA
device by default (complex64 there, as the JAX harness runs on an
accelerator) or on ``--device cpu`` (complex128 unless ``-s``).  Each
device timing chains ``reps`` applications between two
``torch.cuda.synchronize()`` calls.

    python -m quflow_tpu_torch.profiling [-s] [-b BASENAME] [--nmax 1024]
        [--lmax 10] [--device DEVICE]
"""

from __future__ import annotations

import argparse
import datetime
import time

import numpy as np
import torch

FIELDS = ["N", "matmul", "commutator", "poisson", "inner", "isomp_step",
          "shr2mat", "mat2shr"]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _chain(body, x, reps):
    for _ in range(reps):
        x = body(x)
    return x


def _timed_chain(body, x0, reps, dev):
    """Seconds per application of ``x -> body(x)``, chained ``reps``
    times between two synchronizations, after one untimed chain (which
    leaves the allocator's blocks and cuBLAS's state in place)."""
    _chain(body, x0, reps)
    _sync(dev)
    t0 = time.perf_counter()
    _chain(body, x0, reps)
    _sync(dev)
    return (time.perf_counter() - t0) / reps


def _sizes(nmax):
    sizes = [2**k for k in range(5, nmax.bit_length())]
    if sizes and sizes[-1] != nmax and nmax >= 32:
        sizes.append(nmax)
    return sizes


def profile_row(N, dev, cdtype, lmax):
    """The timings (seconds) of one N, in the order of FIELDS[1:]."""
    import quflow_tpu_torch as qt
    from quflow_tpu_torch.parallel.stepper import (build_poisson_fn,
                                                   build_step_fn)

    reps = max(2, 2**11 // N)
    rng = np.random.RandomState(0)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    W = (W - W.conj().T) / N
    Wc = torch.from_numpy(W.astype(cdtype)).to(dev)
    rd = Wc.real.dtype

    s30 = torch.tensor(1.0 / 30.0, dtype=rd, device=dev)
    t_mm = _timed_chain(lambda x: (Wc @ x) * s30, Wc, reps, dev)

    def comm(x):
        PW = Wc @ x
        return (PW - PW.mH) * (s30 / 2)

    t_comm = _timed_chain(comm, Wc, reps, dev)
    poisson = build_poisson_fn(N, cdtype, device=dev)
    t_poi = _timed_chain(lambda x: poisson(x) + Wc * 0.0, Wc, reps, dev)

    def inner(acc):
        return acc + torch.sum(Wc * torch.conj(Wc)).real / N

    t_inner = _timed_chain(inner, torch.zeros((), dtype=rd, device=dev),
                           reps, dev)
    step = build_step_fn(N, 0.25 * qt.hbar(N), steps=1, maxit=5,
                         dtype=cdtype, device=dev)
    z = torch.zeros_like(Wc)

    def isomp_step(st):
        return step(*st)

    t_isomp = _timed_chain(isomp_step, (Wc, z, z), reps, dev)

    omega = np.random.RandomState(1).randn(min(lmax + 1, N) ** 2)
    t0 = time.perf_counter()
    Wq = qt.shr2mat(omega, N=N)
    t_shr2mat = time.perf_counter() - t0
    t0 = time.perf_counter()
    qt.mat2shr(Wq)
    t_mat2shr = time.perf_counter() - t0
    return [t_mm, t_comm, t_poi, t_inner, t_isomp, t_shr2mat, t_mat2shr]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-s", "--single", action="store_true",
                        help="single precision (complex64)")
    parser.add_argument("-b", "--basename", default="profile")
    parser.add_argument("--nmax", type=int, default=1024)
    parser.add_argument("--lmax", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; "
                             "without a card pass --device cpu)")
    args = parser.parse_args(argv)

    from quflow_tpu_torch import config

    dev = config.device(args.device)
    platform = dev.type
    cdtype = (np.complex64 if (args.single or platform == "cuda")
              else np.complex128)
    prec_tag = "c" if cdtype == np.complex64 else "z"
    if platform == "cuda":
        described = (f"{torch.cuda.get_device_name(dev)} x "
                     f"{torch.cuda.device_count()}")
    else:
        described = "cpu"

    rows = []
    with torch.no_grad():
        for N in _sizes(args.nmax):
            row = [N] + profile_row(N, dev, cdtype, args.lmax)
            rows.append(row)
            print(f"N={N:5d}  " + "  ".join(
                f"{name} {t * 1e3:9.3f}ms"
                for name, t in zip(FIELDS[1:], row[1:])), flush=True)

    date = datetime.datetime.now().strftime("%Y%m%d")
    outname = f"{args.basename}_{platform}_{prec_tag}_{date}.txt"
    with open(outname, "w") as f:
        f.write("\t".join(FIELDS) + "\n")
        for row in rows:
            f.write("\t".join(str(x) for x in row) + "\n")
        f.write(f"\nplatform: {platform}\ndevices: {described}\n"
                f"torch: {torch.__version__}\n")
    print("wrote", outname)
    return outname


if __name__ == "__main__":
    main()
