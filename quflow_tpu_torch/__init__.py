"""quflow_tpu_torch: quantized vorticity flows on PyTorch and CUDA.

The port of quflow_tpu (JAX) to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper.  Module paths follow quflow_tpu, so each piece's
counterpart is found under the same name; quflow_tpu stays the reference
that the tests hold this package against.  This package imports torch,
numpy and scipy, never jax; h5py (QuSimulation) and tqdm (progress bars)
are imported at first use.

The ported slices are the reference-semantics layer (the Poisson family
of ops/laplacian.py and the ``laplacian`` compatibility package, the
``isomp``, Runge-Kutta and ``magmp`` integrators, the physics functionals,
geometry, spectral analysis and dynamics helpers, the Euler, MHD and
global-QG models, and ``solve`` with ``isomp`` as its default) and the
production steppers (``IsompTorch``, ``MagmpTorch`` and their build functions,
with forcing, Strang splitting, named Hamiltonians and adaptive ``tol``,
on one state, an ensemble (``batched``) or a ``torch.distributed`` mesh),
and persistence (``io``, ``QuSimulation``, ``create_runfile``, the
checkpoints of ``parallel.distributed``).  Still missing: graphics and the
cluster launcher.
Every Poisson-family solve runs the column kernel on the card:

    import numpy as np
    import quflow_tpu_torch as qf

    W0 = qf.EulerFlow(1024, np.complex128).random_initial(lmax=10, seed=42)
    W = qf.solve(W0, stepsize=0.25, simtime=10.0, steps_out=100)

or, for the production speed, a fixed iteration count with no host sync:

    W = qf.solve(W0.astype(np.complex64), stepsize=0.25, steps=100,
                 integrator=qf.IsompTorch(maxit=5, dtype=np.complex64))
"""

from . import config  # noqa: F401  (turns TF32 off; see config.py)

from .utils import (
    elm2ind,
    ind2elm,
    complex_dtype,
    real_dtype,
    berezin_multipliers,
    cart2sph,
    sph2cart,
    sphgrid,
    qtime2seconds,
    seconds2qtime,
    poisson_finite_differences,
)
from .ops import geometry
from .ops.geometry import (
    hbar,
    bracket,
    norm_L2,
    inner_L2,
    norm_Linf,
    norm_L1,
    integral,
    so3_generators,
    rotate,
    cartesian_generators,
    grad,
)
# the compat subpackage re-exports the unified backend and the reference's
# per-backend module paths (as quflow_tpu binds it)
from . import laplacian
from .ops.laplacian import (
    laplace,
    solve_poisson,
    solve_heat,
    solve_helmholtz,
    solve_viscdamp,
    solve_globalqg,
)
from .laplacian.direct import compute_direct_laplacian
from .quantization import (
    basis_break_index,
    compute_basis,
    get_basis,
    shr2mat,
    mat2shr,
    shc2mat,
    mat2shc,
    shr2mat_,
    mat2shr_,
    shc2mat_,
    mat2shc_,
    elmr2mat,
    elmc2mat,
    adjust_basis_orientation_,
    shr2mat_serial_,
    shr2mat_parallel_,
    mat2shr_serial_,
    mat2shr_parallel_,
)
from . import transforms
from .transforms import (
    fun2shc,
    shc2fun,
    fun2shr,
    shr2fun,
    shc2shr,
    shr2shc,
    fun2img,
    img2fun,
    as_fun,
    as_shr,
    forward,
    inverse,
    mw2gl,
    gl2mw,
)
from . import integrators
from .integrators import (
    isomp,
    isomp_fixedpoint,
    isomp_quasinewton,
    isomp_simple,
    estimate_stepsize,
    commutator,
    commutator_generic,
    commutator_skewherm,
    euler,
    heun,
    rk4,
    magmp,
    magmp_fixedpoint,
)
from .integrators.mhd import solve_mhd
from .integrators.isospectral import select_skewherm
from . import physics
from .physics import energy_euler, enstrophy, inner_H1, inner_Hm1
from . import analysis
from .analysis import (
    scale_decomposition,
    energy_spectrum,
    enstrophy_spectrum,
    random_shr,
    gamma_ratio,
)
from . import dynamics
from .dynamics import project_el, blob, north_blob
from . import io
from .io import (
    load_basis,
    save_basis,
    get_basis_dirs,
    get_basis_files,
    get_N_for_basis,
    load_basis_hdf5,
    load_basis_npy,
    load_basis_mat,
    save_basis_hdf5,
    convert_mat_to_hdf5_basis,
    determine_qtype,
    QuData,
    save,
    load,
)
from . import sim
from . import simulation  # alias module, the reference's name
from .sim import QuSimulation, create_runfile
from .sim.solve import solve, in_notebook
from . import models
from .models import EulerFlow, GlobalQGFlow, MHDFlow
from . import parallel
from . import experimental
from .parallel.stepper import IsompTorch, MagmpTorch

__version__ = "0.1.0"
