from .euler import EulerFlow
from .mhd import MHDFlow

__all__ = ["EulerFlow", "MHDFlow"]
