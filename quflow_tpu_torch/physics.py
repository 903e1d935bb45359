"""Physical functionals used as simulation loggers: energy and enstrophy.

Counterpart of quflow_tpu/physics.py:43-51.  The Poisson solve is the
port's shear-layout core (parallel/stepper.build_poisson_fn); the
row-packed ops/laplacian.py backend that quflow_tpu uses here waits for
ROADMAP A6.  Both take and return numpy, the logger boundary of
QuSimulation.  The energy's solve runs on ``device``: by default the CUDA
device (quflow_tpu_torch.config.device), which raises without one; pass
``device="cpu"`` there, e.g. through functools.partial for a logger.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import config
from .ops.geometry import inner_L2

__all__ = ["energy_euler", "enstrophy"]


@lru_cache(maxsize=8)
def _poisson(N, dtype, device):
    from .parallel.stepper import build_poisson_fn

    return build_poisson_fn(N, dtype, device=device)


@torch.no_grad()
def energy_euler(W, *, device=None):
    """Kinetic energy -<W, P>/2 of the Euler state W, solved on
    ``device``."""
    W = torch.from_numpy(np.ascontiguousarray(W)).to(config.device(device))
    P = _poisson(W.shape[-1], W.dtype, W.device)(W)
    return (-inner_L2(W, P) / 2.0).cpu().numpy()


def enstrophy(W):
    """Enstrophy <W, W>/2."""
    W = np.asarray(W)
    return inner_L2(W, W) / 2.0
