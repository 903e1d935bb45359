from .euler import EulerFlow
from .qg import GlobalQGFlow
from .mhd import MHDFlow

__all__ = ["EulerFlow", "GlobalQGFlow", "MHDFlow"]
