"""Distribution helpers of the port (single device so far: the step-time
monitor)."""

from .straggler import StragglerMonitor

__all__ = ["StragglerMonitor"]
