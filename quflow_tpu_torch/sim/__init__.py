from .simulation import QuSimulation
from .solve import solve
from .runfile import create_runfile
from . import registry

__all__ = ["QuSimulation", "solve", "create_runfile", "registry"]
