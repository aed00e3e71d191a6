"""Distribution helpers of the port on one device: the step-time monitor,
gradient compression with error feedback and microbatching."""

from .straggler import StragglerMonitor

__all__ = ["StragglerMonitor"]
