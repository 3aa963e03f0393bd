"""Levenshtein distance by dynamic programming, in plain PyTorch: the full
DP of a block of guide pairs (:func:`leven_block`), its top-k, which is the
plain version of ``csrc/leven_topk.cu`` (:func:`leven_topk_plain`), and the
banded DP of the retention filter's verification tier
(:func:`banded_leven_pairs`).

The counterparts of ``leven_block`` and ``banded_leven_pairs`` in the JAX
package's ``knn/leven.py``.  A DP row is computed in two passes::

    E[j]    = min(D[i-1][j] + 1, D[i-1][j-1] + cost(i, j))
    D[i][j] = min(E[j], D[i][j-1] + 1)

the second being the closure that the JAX package writes as a cummin; it
is written here as a loop over the row, each step one elementwise op over
the whole block (``torch.cummin`` over a short dimension is some fifty
times slower on the CPU).  The cost is 1 for unequal bases and for an N on
either side: an N matches nothing, not even another N, as in the
kernels.  The JAX package's DP lets N equal N, so the two differ on
guides with an N; its Myers engine, used below 32 bases, agrees with this.
"""
from __future__ import annotations

import torch

from .hamming import INF_KEY, MAX_K, pack_keys

#: query x database pairs in one DP block: CPU and card
_BLOCK = {"cpu": (64, 8192), "cuda": (1024, 16384)}


def _fold_n(codes: torch.Tensor, n_code: int) -> torch.Tensor:
    """Codes with every N (>= 4) set to ``n_code``: a query N (4) and a
    database N (5) then compare unequal to everything, each other
    included."""
    return torch.where(codes >= 4, n_code, codes.to(torch.uint8))


def _dp(qf: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """(tq, td) int32 distances of N-folded (tq, L) x (td, L) codes."""
    length = qf.shape[1]
    qi = qf.t().contiguous()[:, :, None]            # (L, tq, 1)
    dj = df.t().contiguous()[:, None, :]            # (L, 1, td)
    tq, td = qi.shape[1], dj.shape[2]
    # distances are at most 2L <= 64: int8 halves the bytes of int16
    d = torch.arange(length + 1, dtype=torch.int8, device=qf.device)
    d = d[:, None, None].expand(length + 1, tq, td).clone()
    e = torch.empty((length, tq, td), dtype=torch.int8, device=qf.device)
    for i in range(length):
        torch.minimum(d[:-1] + (qi[i] != dj), d[1:] + 1, out=e)
        d[0] = i + 1
        for j in range(length):
            torch.minimum(e[j], d[j] + 1, out=d[j + 1])
    return d[-1].to(torch.int32)


def leven_block(qc: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """(tq, td) int32 Levenshtein distances of every pair of (tq, L) query
    codes and (td, L) database codes."""
    return _dp(_fold_n(qc, 4), _fold_n(dc, 5))


def _codes_of(rows: torch.Tensor, length: int) -> torch.Tensor:
    """(n, 2) packed rows -> (n, L) uint8 codes, N = 4."""
    shifts = 2 * torch.arange(length, device=rows.device)
    code = (rows[:, :1] >> shifts) & 3
    valid = (rows[:, 1:] >> shifts) & 1
    return torch.where(valid == 1, code, 4).to(torch.uint8)


def leven_topk_plain(q: torch.Tensor, db: torch.Tensor, length: int,
                     k: int) -> torch.Tensor:
    """(nq, min(k, nd, MAX_K)) int32 packed keys ``(dist << 24) | idx`` of
    each query's nearest database rows by Levenshtein distance, ascending;
    ``q`` and ``db`` are (n, 2) packed rows."""
    nd = db.shape[0]
    k_eff = min(k, nd, MAX_K)
    tq, td = _BLOCK[q.device.type]
    qf = _fold_n(_codes_of(q, length), 4)
    df = _fold_n(_codes_of(db, length), 5)
    out = torch.empty((q.shape[0], k_eff), dtype=torch.int32, device=q.device)
    for qlo in range(0, q.shape[0], tq):
        qt = qf[qlo:qlo + tq]
        best = torch.full((qt.shape[0], k_eff), INF_KEY, dtype=torch.int32,
                          device=q.device)
        for lo in range(0, nd, td):
            dist = _dp(qt, df[lo:lo + td])
            idx = torch.arange(lo, lo + dist.shape[1], device=q.device)
            cand = torch.cat([best, pack_keys(dist, idx)], dim=1)
            best = torch.topk(cand, k_eff, dim=1, largest=False).values
        out[qlo:qlo + qt.shape[0]] = best
    return out


#: larger than any distance in the band
_BIG = 1 << 20


def banded_leven_pairs(a: torch.Tensor, b: torch.Tensor,
                       t: int) -> torch.Tensor:
    """(n,) int32 Levenshtein distances of the row pairs of (n, L) codes
    ``a`` and ``b``, exact where the distance is <= ``t`` and ``t + 1``
    where it is larger (a script of more than t edits leaves the +-t
    diagonal band, so the band's bound is itself sound).  The band holds
    2t + 1 cells a row; lane o of row i is column j = i + o - t."""
    n, length = a.shape
    w = 2 * t + 1
    af = _fold_n(a, 4).to(torch.int32)
    bf = _fold_n(b, 5).to(torch.int32)
    dev = a.device
    offs = torch.arange(-t, t + 1, device=dev)
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    band = torch.where(offs >= 0, offs, _BIG).to(torch.int32)
    band = band.expand(n, w).clone()                      # D[0][j] = j
    for i in range(1, length + 1):
        j = i + offs
        in_band = (j >= 0) & (j <= length)
        bj = bf[:, (j - 1).clamp(0, length - 1)]            # (n, w)
        sub = band + (af[:, i - 1:i] != bj).to(torch.int32)
        dele = torch.cat([band[:, 1:], big.expand(n, 1)], dim=1) + 1
        e = torch.minimum(sub, dele)
        e = torch.where(j == 0, i, e)                     # D[i][0] = i
        e = torch.where(in_band, e, big)
        band[:, 0] = e[:, 0]
        for o in range(1, w):
            band[:, o] = torch.minimum(e[:, o], band[:, o - 1] + 1)
        band = torch.where(in_band, band, big)
    return band[:, t].clamp(max=t + 1)
