from .basis import basis_break_index, compute_basis, get_basis, basis_block
from .basis import _orient_columns as adjust_basis_orientation_  # reference name
from .transforms import (
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
)

# Reference low-level kernel aliases (quflow/quantization.py defines serial
# and prange variants; here one vectorized implementation serves both).
shr2mat_serial_ = shr2mat_parallel_ = shr2mat_
mat2shr_serial_ = mat2shr_parallel_ = mat2shr_
