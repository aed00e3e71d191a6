"""Data sources of the port."""

from .pipeline import SyntheticLM, TeacherStudent

__all__ = ["SyntheticLM", "TeacherStudent"]
