"""Reference-compatible alias module: ``quflow.simulation`` ->
quflow_tpu_torch.sim (the counterpart of quflow_tpu/simulation.py)."""

from .sim.simulation import (
    QuSimulation,
    _default_qutype2varname,
    _default_qutypes,
)
from .sim.solve import solve
from .sim.runfile import create_runfile

__all__ = [
    "QuSimulation",
    "solve",
    "create_runfile",
    "_default_qutypes",
    "_default_qutype2varname",
]
