from .stepper import (
    build_step_fn,
    build_poisson_fn,
    IsompTorch,
    factors_from_numpy,
    state_from_planes,
    to_planes,
    from_planes,
)
