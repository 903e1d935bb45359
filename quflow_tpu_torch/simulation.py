"""Reference-compatible alias module: ``quflow.simulation`` ->
quflow_tpu_torch.sim (the counterpart of quflow_tpu/simulation.py).
``create_runfile`` waits for the persistence slice (ROADMAP A5)."""

from .sim.simulation import (
    QuSimulation,
    _default_qutype2varname,
    _default_qutypes,
)
from .sim.solve import solve

__all__ = [
    "QuSimulation",
    "solve",
    "_default_qutypes",
    "_default_qutype2varname",
]
