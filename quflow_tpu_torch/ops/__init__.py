from .geometry import hbar, bracket, norm_L2, inner_L2
from .diagpack import mat2shear, shear2mat, subtract_col0_mean
from .cuda_solve import shear_thomas, shear_thomas_reference
