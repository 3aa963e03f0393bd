"""Shim mirroring ``guidemaker.doench_featurization`` (see
score/doench_features.py).

The reference exposes ``featurize_data(df, learn_options, ...)`` returning a
dict of per-block DataFrames (its doench_featurization.py:36-83); this
wrapper gives that contract on top of the vectorized featurizer.
``parallel_featurize_data`` is an alias: the vectorized path needs no
process pool.
"""
from __future__ import annotations

from typing import Dict

import pandas as pd

from .score.doench_features import N_FEATURES, featurize  # noqa: F401
from .score.tm import tm_rna_nn2  # noqa: F401

_BLOCKS = [
    ("_nuc_pd_Order1", 0, 120), ("_nuc_pi_Order1", 120, 124),
    ("_nuc_pd_Order2", 124, 588), ("_nuc_pi_Order2", 588, 604),
    ("gc_above_10", 604, 605), ("gc_below_10", 605, 606),
    ("gc_count", 606, 607), ("NGGX", 607, 623), ("Tm", 623, 627),
]


def featurize_data(data: pd.DataFrame, learn_options: dict = None,
                   pam_audit: bool = True, length_audit: bool = True
                   ) -> Dict[str, pd.DataFrame]:
    """30-mer DataFrame (column "30mer") -> dict of feature-block frames."""
    seqs = list(data["30mer"])
    if length_audit and any(len(s) != 30 for s in seqs):
        raise AssertionError("Sequences should be 30 nt long")
    full = featurize(seqs, pam_audit=pam_audit)
    return {name: pd.DataFrame(full[:, lo:hi], index=data.index)
            for name, lo, hi in _BLOCKS}


def parallel_featurize_data(data: pd.DataFrame, learn_options: dict = None,
                            pam_audit: bool = True, length_audit: bool = True,
                            num_threads: int = 1) -> Dict[str, pd.DataFrame]:
    """API-compatible alias; the vectorized featurizer needs no pool."""
    return featurize_data(data, learn_options, pam_audit, length_audit)
