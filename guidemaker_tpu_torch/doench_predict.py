"""Shim mirroring ``guidemaker.doench_predict`` (see score/doench.py)."""
from .score.doench import predict  # noqa: F401
