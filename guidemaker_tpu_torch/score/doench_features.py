"""Doench et al. 2016 featurization: 30-mer -> 627 features, vectorized.

The reference GuideMaker builds the features in per-sequence Python loops
over a process pool (its ``doench_featurization.py:85-218``); here each
block is one batched numpy pass over the whole code matrix.

Feature blocks, concatenated in the reference's dict-insertion order
(its ``doench_predict.py:45-80`` and ``doench_featurization.py:53-77``),
which the model requires exactly:

    _nuc_pd_Order1  (120)  position-dependent mononucleotide one-hot (ATCG)
    _nuc_pi_Order1  (4)    mononucleotide counts (ATCG)
    _nuc_pd_Order2  (464)  position-dependent dinucleotide one-hot (ATCG x ATCG)
    _nuc_pi_Order2  (16)   dinucleotide counts
    gc_above_10     (1)    gc_count > 10 over the 20-mer [4:24]
    gc_below_10     (1)    gc_count < 10
    gc_count        (1)
    NGGX            (16)   one-hot of seq[24]+seq[27] (ACGT x ACGT)
    Tm              (4)    RNA_NN2 melting temperatures (see tm.py)

Column order inside the nucleotide blocks follows ``product('ATCG', ...)``
(the reference's ``doench_featurization.py:127-140``); NGGX follows
``product('ACGT', ...)`` (its ``doench_featurization.py:264``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import dna
from .tm import tm_features

N_FEATURES = 627

#: which of the 627 feature columns are small non-negative integers
#: (everything except the 4 Tm columns at [623:627))
INT_FEATURE_MASK = np.ones(N_FEATURES, dtype=bool)
INT_FEATURE_MASK[623:] = False

#: ACGT code -> index in 'ATCG' ordering (A=0, T=1, C=2, G=3).
_CODE_TO_ATCG = np.array([0, 2, 3, 1], dtype=np.int64)


def encode30(seqs: Sequence[str]) -> np.ndarray:
    """Encode and validate a batch of 30-mers (uppercase ACGT)."""
    seqs = list(seqs)
    if any(len(s) != 30 for s in seqs):
        raise AssertionError("Sequences should be 30 nt long")
    arr = dna.encode_batch(seqs, 30)
    if (arr >= 4).any():
        raise AssertionError("sequences must be ACGT only")
    return arr


def featurize(seqs: Sequence[str], pam_audit: bool = True) -> np.ndarray:
    """(n,) 30-mer strings -> (n, 627) float32 feature matrix."""
    return featurize_codes(encode30(seqs), pam_audit=pam_audit)


def featurize_codes(codes: np.ndarray, pam_audit: bool = True) -> np.ndarray:
    """(n, 30) uint8 code matrix -> (n, 627) feature matrix.

    The string-free entry point: the pipeline's 30-mer column is
    Arrow-backed, so the codes come straight off the buffer
    (``dna.encode_pandas``) without materializing Python strings."""
    codes = np.asarray(codes)
    n = codes.shape[0]
    if codes.shape[1] != 30:
        raise AssertionError("Sequences should be 30 nt long")
    if (codes >= 4).any():
        raise AssertionError("sequences must be ACGT only")
    if pam_audit:
        bad = (codes[:, 25] != dna.G) | (codes[:, 26] != dna.G)
        if bad.any():
            i = int(np.nonzero(bad)[0][0])
            raise Exception(
                f"expected GG but found {dna.decode(codes[i, 25:27])}")

    atcg = _CODE_TO_ATCG[codes]                       # (n, 30) in ATCG order

    # every block is filled into one float32 matrix in place: each is a
    # small non-negative integer (exact in f32) except Tm, which is
    # computed in float64 and cast once, the same values as building in
    # f64 and casting the whole matrix (what onnxruntime was given).
    # Fortran order: the tree descent reads single columns
    out = np.zeros((n, N_FEATURES), dtype=np.float32, order="F")

    eye4 = np.eye(4, dtype=np.float32)
    eye16 = np.eye(16, dtype=np.float32)

    # _nuc_pd_Order1 @ [0:120): one-hot, 4 cols per position
    out[:, :120] = eye4[atcg].reshape(n, 120)

    # _nuc_pi_Order1 @ [120:124): counts, one bincount over (row, base) bins
    out[:, 120:124] = np.bincount(
        (np.arange(n)[:, None] * 4 + atcg).reshape(-1),
        minlength=4 * n).reshape(n, 4)

    # dinucleotide index in product('ATCG', repeat=2) order
    d2 = atcg[:, :-1] * 4 + atcg[:, 1:]               # (n, 29)

    # _nuc_pd_Order2 @ [124:588): one-hot, 16 cols per position
    out[:, 124:588] = eye16[d2].reshape(n, 464)

    # _nuc_pi_Order2 @ [588:604): counts
    out[:, 588:604] = np.bincount(
        (np.arange(n)[:, None] * 16 + d2).reshape(-1),
        minlength=16 * n).reshape(n, 16)

    # GC features over the 20-mer [4:24] @ [604:607)
    gc_count = ((codes[:, 4:24] == dna.G) | (codes[:, 4:24] == dna.C)) \
        .sum(axis=1)
    out[:, 604] = gc_count > 10
    out[:, 605] = gc_count < 10
    out[:, 606] = gc_count

    # NGGX @ [607:623): one-hot of seq[24] + seq[27], product('ACGT') order
    nx = codes[:, 24].astype(np.int64) * 4 + codes[:, 27].astype(np.int64)
    out[np.arange(n), 607 + nx] = 1.0

    # Tm @ [623:627)
    out[:, 623:627] = tm_features(codes)
    return out
