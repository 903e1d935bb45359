"""quflow_tpu_torch: quantized vorticity flows on PyTorch and CUDA.

The port of quflow_tpu (JAX) to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper.  Module paths follow quflow_tpu, so each piece's
counterpart is found under the same name; quflow_tpu stays the reference
that the tests hold this package against.  This package imports torch,
numpy and scipy, never jax; h5py (QuSimulation) and tqdm (progress bars)
are imported at first use.

The ported slices are the production Euler run and the production MHD
run (``MHDFlow`` with ``MagmpTorch``):

    import numpy as np
    from quflow_tpu_torch import solve, energy_euler
    from quflow_tpu_torch.models import EulerFlow
    from quflow_tpu_torch.parallel.stepper import IsompTorch

    W0 = EulerFlow(1024, np.complex64).random_initial(lmax=10, seed=42)
    W = solve(W0, stepsize=0.25, steps=100, steps_out=20,
              integrator=IsompTorch(maxit=5, dtype=np.complex64))
"""

from . import config  # noqa: F401  (turns TF32 off; see config.py)

from .utils import elm2ind, ind2elm, complex_dtype, real_dtype
from .ops import geometry
from .ops.geometry import hbar, bracket, norm_L2, inner_L2
from .quantization import (
    compute_basis,
    get_basis,
    shr2mat,
    mat2shr,
    shc2mat,
    mat2shc,
)
from . import transforms
from .transforms import fun2shc, shc2fun, fun2shr, shr2fun, shc2shr, shr2shc
from . import physics
from .physics import energy_euler, enstrophy
from .analysis import random_shr
from . import sim
from .sim import QuSimulation, solve
from . import models
from .models import EulerFlow, MHDFlow
from . import parallel
from .parallel.stepper import IsompTorch, MagmpTorch

__version__ = "0.1.0"
