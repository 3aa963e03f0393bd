"""Nearest-neighbor melting temperature (Tm), vectorized.

The ``Bio.SeqUtils.MeltingTemp.Tm_NN`` computation as the reference
GuideMaker's Doench featurization calls it (its
``doench_featurization.py:334-343``): ``Tm_NN(seq, nn_table=RNA_NN2)`` with
every other argument at its default (dnac1=25, dnac2=25, Na=50,
saltcorr=5, perfectly matched complement).

RNA_NN2 is the Xia et al. (1998) RNA/RNA nearest-neighbor table
(Biochemistry 37:14719), written DNA-alphabet style as in Biopython.  For
a perfectly matched ACGT duplex the algorithm reduces to:

    dH = init_H + termAT_H * (#terminal A/T) + sum_i step_H[s_i, s_{i+1}]
    dS = likewise
    Tm = 1000*dH / (dS + 0.368*(N-1)*ln[Na+] + R*ln(dnac1 - dnac2/2)) - 273.15

(the terminal-mismatch, internal-mismatch and dangling-end tables never
fire for a matched duplex; the all-A/T and 5'-T initiation terms are zero
in RNA_NN2).  The sums run left to right in float64, one dinucleotide step
at a time, as Biopython accumulates them: that order is what makes the
result equal Biopython's to the last bit, so it is not a ``sum``, a
``cumsum`` or a matmul.
"""
from __future__ import annotations

import math

import numpy as np

from .. import dna

# Xia et al. (1998) RNA duplex parameters, (delta-H kcal/mol, delta-S eu),
# keyed like Biopython's RNA_NN2 (T stands for U).
RNA_NN2 = {
    "init": (3.61, -1.5),
    "init_A/T": (3.72, 10.5),
    "init_G/C": (0.0, 0.0),
    "init_oneG/C": (0.0, 0.0),
    "init_allA/T": (0.0, 0.0),
    "init_5T/A": (0.0, 0.0),
    "sym": (0.0, -1.4),
    "AA/TT": (-6.82, -19.0), "AT/TA": (-9.38, -26.7), "TA/AT": (-7.69, -20.5),
    "CA/GT": (-10.44, -26.9), "GT/CA": (-11.40, -29.5), "CT/GA": (-10.48, -27.1),
    "GA/CT": (-12.44, -32.5), "CG/GC": (-10.64, -26.7), "GC/CG": (-14.88, -36.9),
    "GG/CC": (-13.39, -32.7),
}

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _step_tables():
    """(4,4) dH/dS lookup over (code_i, code_{i+1}) dinucleotide steps."""
    dh = np.zeros((4, 4), dtype=np.float64)
    ds = np.zeros((4, 4), dtype=np.float64)
    for i, x in enumerate(dna.BASES):
        for j, y in enumerate(dna.BASES):
            key = x + y + "/" + _COMP[x] + _COMP[y]
            if key in RNA_NN2:
                v = RNA_NN2[key]
            elif key[::-1] in RNA_NN2:
                v = RNA_NN2[key[::-1]]
            else:  # pragma: no cover - all 16 resolve
                raise KeyError(key)
            dh[i, j], ds[i, j] = v
    return dh, ds


_STEP_DH, _STEP_DS = _step_tables()

_R = 1.987  # universal gas constant, cal/(K*mol)


def tm_rna_nn2(codes: np.ndarray, *, dnac1: float = 25.0, dnac2: float = 25.0,
               na_mM: float = 50.0) -> np.ndarray:
    """Tm (Celsius) for a batch of equal-length ACGT code rows (n, L)."""
    n, length = codes.shape
    init_h, init_s = RNA_NN2["init"]
    # terminal A/T count (init_G/C is zero in this table)
    ends_at = ((codes[:, 0] == dna.A) | (codes[:, 0] == dna.T)).astype(np.float64) \
        + ((codes[:, -1] == dna.A) | (codes[:, -1] == dna.T)).astype(np.float64)
    at_h, at_s = RNA_NN2["init_A/T"]
    dh = init_h + at_h * ends_at
    ds = init_s + at_s * ends_at
    # left-to-right sequential accumulation (Biopython's order, ulp for ulp)
    for i in range(length - 1):
        dh = dh + _STEP_DH[codes[:, i], codes[:, i + 1]]
        ds = ds + _STEP_DS[codes[:, i], codes[:, i + 1]]
    k = (dnac1 - (dnac2 / 2.0)) * 1e-9
    corr = 0.368 * (length - 1) * math.log(na_mM / 1000.0)
    return (1000.0 * dh) / (ds + corr + _R * math.log(k)) - 273.15


def tm_features(codes30: np.ndarray) -> np.ndarray:
    """The 4 Doench Tm features for (n, 30) code rows.

    Columns: 30-mer global Tm, 5-mer [19:24], 8-mer [11:19], 5-mer [6:11]
    (the reference's ``doench_featurization.py:311-356``).
    """
    return np.stack([
        tm_rna_nn2(codes30),
        tm_rna_nn2(codes30[:, 19:24]),
        tm_rna_nn2(codes30[:, 11:19]),
        tm_rna_nn2(codes30[:, 6:11]),
    ], axis=1)
