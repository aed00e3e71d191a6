"""Integrity-checked checkpoints and the packed deployment artifact (the
port of ``repro.checkpoint``)."""

from . import checkpoint  # noqa: F401
from .checkpoint import (ArtifactCorruptError, export_packed, has_packed,
                         latest_step, load_packed, restore, save)

__all__ = ["ArtifactCorruptError", "checkpoint", "export_packed",
           "has_packed", "latest_step", "load_packed", "restore", "save"]
