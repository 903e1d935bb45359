from .erk import euler, heun, rk4, explicit
from .mhd import solve_mhd, magmp_fixedpoint, magmp
from .isospectral import (
    isomp,
    isomp_fixedpoint,
    isomp_quasinewton,
    isomp_simple,
    commutator,
    commutator_skewherm,
    commutator_generic,
    estimate_stepsize,
    update_stats,
)
