from .stepper import (
    build_step_fn,
    build_mhd_step_fn,
    build_poisson_fn,
    build_dw_step_fn,
    build_dw_mhd_step_fn,
    build_planes_step_fn,
    column_solver,
    IsompTorch,
    MagmpTorch,
    factors_from_numpy,
    state_from_planes,
    to_planes,
    from_planes,
)
from .mesh import Mesh, make_mesh, row_blocks, shard_state, gather_state
from . import distributed, shard_pack
