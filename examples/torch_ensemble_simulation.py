#!/usr/bin/env python
"""Ensemble simulation on quflow_tpu_torch, the PyTorch/CUDA twin of
examples/ensemble_simulation.py: a batch of perturbed initial conditions
stepped together (``build_step_fn(batched=True)``: one column-solve launch
and one batched GEMM of the whole ensemble an iteration).  Under torchrun
the members are split over a data-parallel mesh, each rank stepping its
own with no communication (NCCL on the cards, gloo with --device cpu).

Run:  python examples/torch_ensemble_simulation.py [--device cpu]
      torchrun --nproc-per-node 4 examples/torch_ensemble_simulation.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--N", type=int, default=64)
    parser.add_argument("--members", type=int, default=4)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lmax", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    import quflow_tpu_torch as qt
    from quflow_tpu_torch import config
    from quflow_tpu_torch.models import EulerFlow
    from quflow_tpu_torch.parallel import (build_step_fn, distributed,
                                           gather_state, shard_state)

    N, E = args.N, args.members
    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
    up = distributed.initialize(backend="gloo" if on_cpu else None)
    mesh = distributed.global_mesh() if up else None
    device = config.device(args.device)  # under NCCL, this rank's card

    flow = EulerFlow(N=N)
    base = qt.analysis.random_shr(lmax=args.lmax, seed=42)
    rng = np.random.RandomState(0)
    states = np.stack([qt.shr2mat(base + 1e-3 * rng.randn(base.shape[0]),
                                  N=N) for _ in range(E)])

    fn = build_step_fn(N, 0.25 * flow.hbar, steps=args.steps, maxit=5,
                       dtype=np.complex128, compsum=True, mesh=mesh,
                       batched=True, device=device)
    W = torch.from_numpy(states).to(device)
    if mesh is not None:
        W = shard_state(W, mesh, batched=True).contiguous()
    z = torch.zeros_like(W)
    out = fn(W, z, z)[0]
    if mesh is not None:
        out = gather_state(out, mesh, batched=True)
    final = out.cpu().numpy()

    rank = 0 if mesh is None else mesh.rank
    drifts = [np.abs(np.sort(np.linalg.eigvalsh(-1j * final[e]))
                     - np.sort(np.linalg.eigvalsh(-1j * states[e]))).max()
              for e in range(E)]
    if rank == 0:
        print(f"ensemble of {E} trajectories, N={N}, {args.steps} steps on "
              f"{device}, dp={1 if mesh is None else mesh.dp}, captured: "
              f"{fn.captured}")
        for e in range(E):
            en = float(qt.energy_euler(final[e], device="cpu"))
            print(f"  traj {e}: energy {en:.6f}, Casimir drift "
                  f"{drifts[e]:.2e}")
        print(f"ensemble spread after {args.steps} steps: "
              f"{np.abs(final - final[0]).max():.3e}")
    if up:
        import torch.distributed as dist

        dist.destroy_process_group()
    return dict(final=final, casimir_drift=max(drifts))


if __name__ == "__main__":
    main()
