"""Positional 3-gram feature rows of the Levenshtein retention filter, the
plain PyTorch version of their count kernel (``csrc/feature_count.cu``),
and the filter's candidate extraction.

The counterpart of ``_filter_feats`` and ``_gram_feats_on_device`` in the
JAX package's ``knn/leven.py``.  A guide of L bases has G = L - 2
overlapping 3-grams; gram p, of bases p, p+1 and p+2, has the value
``16 c[p] + 4 c[p+1] + c[p+2]`` in 0..63, and a gram touching an N has
none.  A feature row is G int64 words: word p has bit g set iff gram p has
the value g, which is the JAX feature vector's 64 int8 lanes of position p
at one bit each (lane ``64 p + g`` is bit g of word p).  The row dilated by
``t`` sets in word p every gram found at positions p - t .. p + t.

Every feature is 0 or 1, so the dot of two rows is the sum over p of
``popcount(q[p] & d[p])``, at most G when one side is undilated.  The
q-gram lemma makes the count a sound filter: leven(a, b) <= t implies
``dot(gram(a), dilated_t(gram(b))) >= G - 3t``.

The plain versions unpack the rows to 0/1 lanes and take a tile-by-tile
matrix product (float32 on the CPU, bfloat16 on the card), an algorithm
independent of the kernel's popcounts.  With one side undilated every dot
is an integer of at most G <= 30, exact in either type; the filter never
multiplies two dilated rows.
"""
from __future__ import annotations

import torch

from .hamming import INF_KEY, pack_keys

#: q-gram width: 4**3 = 64 gram values fill one 64-bit word exactly
GRAM_Q = 3
#: words of the widest row (32-base guides)
MAX_WORDS = 30

_Q_TILE = 4096
_DB_TILE = 32768


def gram_rows(codes: torch.Tensor, t: int) -> torch.Tensor:
    """(n, L) uint8 codes -> (n, L - 2) int64 feature rows, dilated over
    +-``t`` gram positions (``t`` 0: the plain gram rows), on the codes'
    device."""
    n, length = codes.shape
    glen = length - GRAM_Q + 1
    if not 1 <= glen <= MAX_WORDS:
        raise ValueError(f"3-gram rows need guides of 3..{MAX_WORDS + 2} "
                         f"bases, got {length}")
    c = codes.to(torch.int64)
    g = c[:, :glen] * 16 + c[:, 1:glen + 1] * 4 + c[:, 2:glen + 2]
    valid = ((c[:, :glen] < 4) & (c[:, 1:glen + 1] < 4)
             & (c[:, 2:glen + 2] < 4))
    one = torch.ones_like(g)
    rows = torch.where(valid, one << torch.where(valid, g, 0), 0)
    out = rows.clone()
    for s in range(1, min(t, glen - 1) + 1):
        out[:, s:] |= rows[:, :-s]
        out[:, :-s] |= rows[:, s:]
    return out


def unpack_rows(rows: torch.Tensor, dtype) -> torch.Tensor:
    """(n, G) feature rows -> (n, 64 G) 0/1 lanes of ``dtype``, lane
    ``64 p + g`` = bit g of word p (the JAX feature layout)."""
    bits = torch.arange(64, device=rows.device)
    return ((rows[:, :, None] >> bits) & 1).reshape(rows.shape[0], -1).to(
        dtype)


def _matmul_dtype(device: torch.device):
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def _dots(q: torch.Tensor, db: torch.Tensor):
    """Yield (query offset, db offset, exact dot block) over tiles."""
    dtype = _matmul_dtype(q.device)
    for lo in range(0, db.shape[0], _DB_TILE):
        d = unpack_rows(db[lo:lo + _DB_TILE], dtype)
        for qlo in range(0, q.shape[0], _Q_TILE):
            yield qlo, lo, unpack_rows(q[qlo:qlo + _Q_TILE], dtype) @ d.T


def feature_count_plain(q: torch.Tensor, db: torch.Tensor,
                        thresh: int) -> torch.Tensor:
    """(nq,) int32: for each query row, the database rows whose feature dot
    exceeds ``thresh``."""
    out = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for qlo, _, m in _dots(q, db):
        out[qlo:qlo + m.shape[0]] += (m > thresh).sum(1, dtype=torch.int32)
    return out


def feature_topk(q: torch.Tensor, db: torch.Tensor, n_words: int,
                 k: int) -> torch.Tensor:
    """(nq, min(k, nd)) int32 packed keys ``((n_words - dot) << 24) | idx``
    of each query row's database rows with the largest feature dots,
    ascending: the filter's candidate lists, in order of the counting
    kernel's pseudo-distance.  Either side must be undilated, so that
    ``dot <= n_words``."""
    k_eff = min(k, db.shape[0])
    best = torch.full((q.shape[0], k_eff), INF_KEY, dtype=torch.int32,
                      device=q.device)
    for qlo, lo, m in _dots(q, db):
        idx = torch.arange(lo, lo + m.shape[1], device=q.device)
        keys = pack_keys(n_words - m.to(torch.int32), idx)
        rows = slice(qlo, qlo + m.shape[0])
        cand = torch.cat([best[rows], keys], dim=1)
        best[rows] = torch.topk(cand, k_eff, dim=1, largest=False).values
    return best
