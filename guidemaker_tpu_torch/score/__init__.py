"""Scoring (Doench 2016 on-target, CFD off-target): host numpy, as in the
JAX package."""
from .cfd import cfd_score
from .doench import get_doench_efficiency_score
__all__ = ["cfd_score", "get_doench_efficiency_score"]
