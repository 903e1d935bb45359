"""The 'highest' complex64 product (ops/cgemm.py, csrc/cgemm_tf32x3.cu:
three TF32 passes on the tensor cores) on one CUDA card, beside its
plain version and cuBLAS.

    python3 benchmarks/torch_cgemm.py [--phases check,time,accuracy]
        [--out FILE.jsonl]

Phases, each printed as JSON lines (and, with ``--out``, written there):

- ``check``: the kernel against its plain version (``cgemm_reference``,
  the same split and passes as float32 products) and against float64 at
  N in {1024, 513, 100}, batched, broadcast (stride 0 and size 1),
  strided batches (MHD's Theta of a (B, 2, N, N) state), a tp row block
  and ragged shapes (chip_smoke.cgemm_vs_plain, phase 26);
- ``time``: at the cells' shapes, (1024, 1024) @ (1024, 1024), (1024,
  1024) @ (2, 1024, 1024) broadcast and (16, 1024, 1024) @ (16, 1024,
  1024), the product's ms by CUDA-graph replay in turns with the
  library's float32 CGEMM, each of its two kernels' ms from a profile,
  its bound (24 M N K a product on 495 TFLOP/s TF32) and share, the plain
  version's ms and the library's one-pass TF32 product's
  (chip_smoke.cgemm_times, phase 26);
- ``accuracy``: against float64 at N=1024, normwise ||C - C64||_F /
  ||C64||_F and max_ij |C - C64|_ij / (|A| |B|)_ij, for the kernel,
  cuBLAS FP32, one-pass TF32 and the plain version (with and without a
  fourth pass small.small: the split's own floor), on random normal
  inputs and on the products of a real Euler step (P W and (P W) P, P =
  Delta^-1 W of ``random_initial(lmax=10)``), each as a ratio to cuBLAS
  FP32's and to one-pass TF32's.

Needs one CUDA card and nvcc; imports nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import quflow_tpu_torch as qt  # noqa: E402
from quflow_tpu_torch import config  # noqa: E402
from quflow_tpu_torch.ops import cgemm as cg  # noqa: E402


def four_pass(a, b):
    """The plain version with the small.small pass added."""
    ar, ai = cg.split_tf32(a.real), cg.split_tf32(a.imag)
    br, bi = cg.split_tf32(b.real), cg.split_tf32(b.imag)

    def four(x, y):
        return cg._three(x, y) + x[1] @ y[1]
    return torch.complex(four(ar, br) - four(ai, bi),
                         four(ar, bi) + four(ai, br))


def euler_operands(device, N=1024):
    """(P, W) of ``random_initial(lmax=10)`` at N, complex64: the operands
    of a step's first product, P = Delta^-1 W."""
    W = torch.from_numpy(qt.EulerFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    return qt.solve_poisson(W).to(torch.complex64), W


def accuracy(device, N=1024):
    P, W = euler_operands(device, N)
    sets = (("random_normal", chip_smoke.seeded_c64((N, N), device, 7),
             chip_smoke.seeded_c64((N, N), device, 8)),
            ("euler_P_W", P, W),
            ("euler_PW_P", P @ W, P))
    rows = []
    for name, A, B in sets:
        err = chip_smoke.product_errors
        row = {"name": name, "kernel": err(cg.cgemm(A, B), A, B),
               "cublas_fp32": err(A @ B, A, B)}
        with config.tf32_matmul():
            row["tf32_1pass"] = err(A @ B, A, B)
        row["plain_3pass"] = err(cg.cgemm_reference(A, B), A, B)
        row["plain_4pass"] = err(four_pass(A, B), A, B)
        for key in ("kernel", "plain_3pass", "plain_4pass"):
            row[f"{key}_over_fp32"] = [k / f for k, f in
                                       zip(row[key], row["cublas_fp32"])]
            row[f"{key}_over_tf32"] = [k / f for k, f in
                                       zip(row[key], row["tf32_1pass"])]
        rows.append(row)
    return rows


PHASES = {"check": chip_smoke.cgemm_vs_plain, "time": chip_smoke.cgemm_times,
          "accuracy": accuracy}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="check,time,accuracy")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_cgemm.py needs a CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    path = cg.LIBRARY.build()
    lines = [{"card": smi.splitlines()[0], "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "ptxas": chip_smoke.ptxas_summary(
                  path.with_suffix(".log").read_text())}]
    print(json.dumps(lines[0]), flush=True)
    for phase in args.phases.split(","):
        for row in PHASES[phase](device):
            lines.append({"phase": phase, **row})
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))


if __name__ == "__main__":
    main()
