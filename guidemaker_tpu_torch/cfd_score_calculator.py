"""Shim mirroring ``guidemaker.cfd_score_calculator`` (see score/cfd.py)."""
from .score.cfd import calc_cfd, get_mm_pam_scores, check_len  # noqa: F401
