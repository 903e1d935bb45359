from .euler import EulerFlow

__all__ = ["EulerFlow"]
