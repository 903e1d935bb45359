"""Reference-namespace alias: ``quflow.experimental`` held the accelerator
fast path (DiagTriDiagOp + IsompCUDA).  The counterparts live in
quflow_tpu_torch.parallel.stepper and are re-exported here, as
quflow_tpu/experimental.py re-exports its own.
"""

from .parallel.stepper import (
    IsompTorch,
    MagmpTorch,
    build_dw_mhd_step_fn,
    build_dw_step_fn,
    build_mhd_step_fn,
    build_poisson_fn,
    build_step_fn,
    from_planes,
    to_planes,
)

#: the closest counterpart of the reference's DiagTriDiagOp
DiagTriDiagOp = build_poisson_fn
#: the closest counterpart of the reference's IsompCUDA
IsompCUDA = IsompTorch

__all__ = [
    "IsompTorch",
    "MagmpTorch",
    "build_step_fn",
    "build_poisson_fn",
    "build_mhd_step_fn",
    "build_dw_step_fn",
    "build_dw_mhd_step_fn",
    "to_planes",
    "from_planes",
    "DiagTriDiagOp",
    "IsompCUDA",
]
