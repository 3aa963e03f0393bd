"""Annotation subsystem (feature ingestion + nearest-feature join)."""
from .annotation import Annotation
__all__ = ["Annotation"]
