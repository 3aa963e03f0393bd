"""CFD off-target scoring (Doench et al. 2016 mismatch weights).

The reference GuideMaker's ``cfd_score_calculator.py`` and its
``cfd_score`` DataFrame wrapper (core.py:1129-1148).  The per-pair
:func:`calc_cfd` keeps the reference's length rules (beyond 20 bases the
5' overhang is ignored; below 20, what is there is scored;
cfd_score_calculator.py:81-84) and its omission of the PAM term (its
header comment, cfd_score_calculator.py:5-11).

:func:`cfd_batch` scores (guide, off-target) code arrays against a dense
(position, rna-base, dna-base) weight tensor, the form the pipeline uses
for a whole guide table.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, Tuple

import numpy as np

from .. import dna
from ..definitions import DATA_DIR

logger = logging.getLogger(__name__)

MODEL_META = os.path.join(DATA_DIR, "cfd_data.json")

_RNA_OF_CODE = "ACGU"  # code -> RNA letter (T->U)
#: DNA complement letter of an off-target base, as the reference computes it
#: (basecomp applied to the U-substituted off string, calc_cfd:79).
_BASECOMP = {"A": "T", "C": "G", "G": "C", "T": "A", "U": "A"}


def get_mm_pam_scores() -> Tuple[Dict, Dict]:
    """Load mismatch and PAM score tables (cfd_score_calculator.py:26-40)."""
    try:
        with open(MODEL_META) as dat:
            scores = json.load(dat)
        return scores["mm"], scores["pam"]
    except (FileNotFoundError, IOError):
        raise Exception(
            "Could not find file with reference mismatch scores and PAM scores")


def check_len(wt: str, off: str) -> int:
    wtl, offl = len(wt), len(off)
    assert wtl == offl, \
        "The lengths wt and off differ: wt = {}, off = {}".format(wtl, offl)
    return wtl


def calc_cfd(wt: str, off: str, mm_scores=None) -> float:
    """CFD score of one guide / off-target pair (no PAM term)."""
    guidelen = check_len(wt, off)
    if mm_scores is None:
        mm_scores, _ = get_mm_pam_scores()
    score = 1.0
    off = off.upper().replace("T", "U")
    wt = wt.upper().replace("T", "U")
    for i, sl in enumerate(off):
        if (guidelen - 20 - i) <= 0:
            if wt[i] != sl:
                key = ("r" + wt[i] + ":d" + _BASECOMP[sl] + ","
                       + str(20 + i + 1 - guidelen))
                score *= mm_scores[key]
    return score


_WEIGHTS_CACHE = {}


def weight_tensor(guidelen: int) -> np.ndarray:
    """Dense (guidelen, 4, 4) float64 tensor W[i, wt_code, off_code].

    W is the multiplicative CFD weight at guide position i when the guide
    (RNA) base has code ``wt`` and the off-target (DNA) base has code
    ``off``; 1.0 on matches and positions outside the scored 20-mer window.
    """
    if guidelen in _WEIGHTS_CACHE:
        return _WEIGHTS_CACHE[guidelen]
    mm_scores, _ = get_mm_pam_scores()
    w = np.ones((guidelen, 4, 4), dtype=np.float64)
    for i in range(guidelen):
        if (guidelen - 20 - i) > 0:
            continue  # 5' overhang beyond 20 nt is ignored
        pos = 20 + i + 1 - guidelen
        for wc in range(4):
            for oc in range(4):
                if wc == oc:
                    continue
                rna = _RNA_OF_CODE[wc]
                dnab = _BASECOMP[_RNA_OF_CODE[oc]]
                w[i, wc, oc] = mm_scores[f"r{rna}:d{dnab},{pos}"]
    _WEIGHTS_CACHE[guidelen] = w
    return w


def cfd_batch(wt_codes: np.ndarray, off_codes: np.ndarray) -> np.ndarray:
    """CFD scores for (n, L) guide and off-target code arrays -> (n,)."""
    n, L = wt_codes.shape
    w = weight_tensor(L)
    pos = np.arange(L)
    vals = w[pos[None, :], wt_codes.astype(np.int64), off_codes.astype(np.int64)]
    return vals.prod(axis=1)


def cfd_score(df):
    """Append 'CFD Similar Guides' and 'Max CFD' columns (core.py:1129-1148).

    'CFD Similar Guides' scores every listed similar guide (aligned with the
    'Similar guides' column, which leads with the guide itself at distance
    0).  'Max CFD' is taken over the neighbors that are not identical to
    the guide (the first listed one always is, CFD 1.0), and falls back to
    the max over all entries for a row that lists only the guide.
    """
    # every (guide, similar-guide) pair is scored in one vectorized pass;
    # the split and flatten run in Arrow C kernels, the per-row maxes in
    # numpy
    import pyarrow as pa
    import pyarrow.compute as pc

    n = len(df)
    if n == 0:
        df["CFD Similar Guides"] = []
        df["Max CFD"] = []
        return df
    sims_arr = pa.array(df["Similar guides"], from_pandas=True)
    lists = pc.split_pattern(sims_arr, ";")
    lens = pc.list_value_length(lists).to_numpy().astype(np.int64)
    flat = pc.list_flatten(lists)
    if isinstance(flat, pa.ChunkedArray):
        flat = flat.combine_chunks()
    row_of_pair = np.repeat(np.arange(n), lens)

    # decode the flattened similar-guide strings straight from the Arrow
    # buffers (they share one length L, so the data buffer is an (m, L)
    # byte matrix); fall back to the per-string path on ragged input
    odt = np.int64 if pa.types.is_large_string(flat.type) else np.int32
    offsets = np.frombuffer(flat.buffers()[1], dtype=odt,
                            count=len(flat) + 1,
                            offset=flat.offset * np.dtype(odt).itemsize)
    widths = np.diff(offsets)
    guides = df["Guide sequence"].tolist()
    L = len(guides[0]) if guides else 0
    if len(flat) and (widths == L).all():
        data = np.frombuffer(flat.buffers()[2], dtype=np.uint8)
        off_codes = dna.BYTE_TO_CODE[
            data[offsets[0]:offsets[-1]]].reshape(-1, L)
    else:
        off_codes = dna.encode_batch(flat.to_pylist(), L)
    guide_codes = dna.encode_batch(guides, L)
    wt_codes = guide_codes[row_of_pair]
    scores = cfd_batch(wt_codes, off_codes)

    # Max CFD over the non-identical neighbors; rows whose every listed
    # neighbor is the guide itself fall back to the max over all entries
    ident = (wt_codes == off_codes).all(axis=1)
    max_all = np.full(n, -np.inf)
    np.maximum.at(max_all, row_of_pair, scores)
    max_off = np.full(n, -np.inf)
    np.maximum.at(max_off, row_of_pair[~ident], scores[~ident])
    max_cfds = np.where(np.isneginf(max_off), max_all, max_off)

    # per-row lists of score strings (np.float64.__str__ == float.__str__)
    flat_strs = scores.astype("U32").tolist()
    bounds = np.concatenate([[0], np.cumsum(lens)]).tolist()
    df["CFD Similar Guides"] = [flat_strs[a:b]
                                for a, b in zip(bounds, bounds[1:])]
    df["Max CFD"] = max_cfds
    return df
