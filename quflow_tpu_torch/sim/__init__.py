from .simulation import QuSimulation
from .solve import solve
from . import registry

__all__ = ["QuSimulation", "solve", "registry"]
