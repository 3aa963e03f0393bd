"""The packed-pair layout: two database guides per 128-lane int8 row, and
the plain PyTorch versions of the packed count and top-k kernels
(``csrc/packed_count.cu``, ``csrc/packed_topk.cu``).

The counterpart of the JAX package's ``knn/pallas_packed.py``:

* each base maps to a vertex of the regular tetrahedron in {-1,+1}^3
  (A=(1,1,1), C=(1,-1,-1), G=(-1,1,-1), T=(-1,-1,1), N -> 0); two bases
  dot to 3 if equal and -1 if not, so L bases dot to ``4m - L``;
* a query row is ``[tetra(q) | tetra(q) | 0]`` and a database row
  ``[s * tetra(guide 2j) | tetra(guide 2j+1) | 0]``, with ``s = 4L + 1``
  and ``6L <= 128`` lanes, so L <= 21;
* one 128-lane dot is ``v = s*A + B``, ``A = 4*m_even - L``,
  ``B = 4*m_odd - L``, and ``v + L = s*A + (B + L)`` with
  ``0 <= B + L <= 4L < s`` decodes exactly (:func:`decode`).

A database slot past the last guide (odd nd) is zero and decodes to
``m = L/4``, not to "no match", so both kernels mask it by its global guide
index.  An N is the zero vector too, and counts as a quarter match rather
than a mismatch: the index never sends a guide with an N to this layout
(``KnnIndex``'s N gate).

The plain versions are a tile-by-tile product of query rows and database
rows in float32: every operand is 0, +-1 or +-s with s <= 85 (exact even
in TF32's 11-bit significand) and every partial sum is an integer below
2^24, so the product is exact on either device and whatever the TF32
setting.  The decode then runs as an exact floor division.
"""
from __future__ import annotations

import torch

from .hamming import INF_KEY, MAX_K, pack_keys

#: longest guide two of which fit a 128-lane row (6L <= 128)
MAX_PACKED_LEN = 21
#: int8 lanes of a packed row
LANES = 128

#: tetrahedron vertex per code (A, C, G, T, N -> 0)
_TETRA = torch.tensor([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1],
                       [0, 0, 0]], dtype=torch.int8)

_Q_TILE = 4096
_DB_TILE = 16384    # database rows, i.e. 32,768 guides


def pack_scale(length: int) -> int:
    """The scale s = 4L + 1 that separates the two sums of a row."""
    return 4 * length + 1


def _check_length(length: int) -> None:
    if not 1 <= length <= MAX_PACKED_LEN:
        raise ValueError(f"packed rows hold guides of 1..{MAX_PACKED_LEN} "
                         f"bases, got {length}")


def _tetra(codes: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 codes -> (n, 3L) int8 tetrahedron rows, component-major
    ``[x(L) | y(L) | z(L)]`` (any lane order shared by queries and database
    gives the same dots)."""
    idx = codes.clamp(max=4).long()
    table = _TETRA.to(codes.device)
    return torch.cat([table[:, c][idx] for c in range(3)], dim=1)


def query_rows(codes: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 codes -> (n, 128) int8 query rows ``[t | t | 0]``, on the
    codes' device."""
    n, length = codes.shape
    _check_length(length)
    t = _tetra(codes)
    out = torch.zeros((n, LANES), dtype=torch.int8, device=codes.device)
    out[:, :3 * length] = t
    out[:, 3 * length:6 * length] = t
    return out


def db_rows(codes: torch.Tensor) -> torch.Tensor:
    """(nd, L) uint8 codes -> (ceil(nd/2), 128) int8 database rows
    ``[s * t(2j) | t(2j+1) | 0]``; the odd slot of the last row is zero
    when nd is odd."""
    n, length = codes.shape
    _check_length(length)
    t = _tetra(codes)
    out = torch.zeros((-(-n // 2), LANES), dtype=torch.int8,
                      device=codes.device)
    out[:, :3 * length] = t[0::2] * pack_scale(length)
    out[:n // 2, 3 * length:6 * length] = t[1::2]
    return out


def decode(v: torch.Tensor, length: int):
    """(A, B) of ``v = s*A + B``, exact: ``A = floor((v + L) / s)``."""
    s = pack_scale(length)
    a = torch.div(v + length, s, rounding_mode="floor")
    return a, v - s * a


def _tiles(q: torch.Tensor, db: torch.Tensor):
    """Yield (query offset, db row offset, exact float32 dot block)."""
    for lo in range(0, db.shape[0], _DB_TILE):
        d = db[lo:lo + _DB_TILE].to(torch.float32)
        for qlo in range(0, q.shape[0], _Q_TILE):
            yield qlo, lo, q[qlo:qlo + _Q_TILE].to(torch.float32) @ d.T


def packed_count_plain(q: torch.Tensor, db: torch.Tensor, nd: int,
                       length: int, editdist: int) -> torch.Tensor:
    """(nq,) int32: for each query row, the database guides at Hamming
    distance < ``editdist`` (``A > 3L - 4*editdist``, and B alike)."""
    thresh = 3 * length - 4 * editdist
    out = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for qlo, lo, v in _tiles(q, db):
        a, b = decode(v, length)
        # every even slot is a guide; an odd slot past nd is masked
        odd_real = 2 * torch.arange(lo, lo + v.shape[1],
                                    device=q.device) + 1 < nd
        out[qlo:qlo + v.shape[0]] += (
            (a > thresh).sum(1, dtype=torch.int32)
            + ((b > thresh) & odd_real).sum(1, dtype=torch.int32))
    return out


def packed_topk_plain(q: torch.Tensor, db: torch.Tensor, nd: int,
                      length: int, k: int) -> torch.Tensor:
    """(nq, min(k, nd, MAX_K)) int32 packed keys ``(dist << 24) | idx`` of
    each query row's nearest database guides, ascending."""
    k_eff = min(k, nd, MAX_K)
    best = torch.full((q.shape[0], k_eff), INF_KEY, dtype=torch.int32,
                      device=q.device)
    for qlo, lo, v in _tiles(q, db):
        a, b = decode(v, length)
        even = 2 * torch.arange(lo, lo + v.shape[1], device=q.device)
        # 3L - A = 4 * (L - m): the distance, exactly
        keys_e = pack_keys(((3 * length - a).to(torch.int32) >> 2), even)
        keys_o = torch.where(
            even + 1 < nd,
            pack_keys(((3 * length - b).to(torch.int32) >> 2), even + 1),
            INF_KEY)
        rows = slice(qlo, qlo + v.shape[0])
        cand = torch.cat([best[rows], keys_e, keys_o], dim=1)
        best[rows] = torch.topk(cand, k_eff, dim=1, largest=False).values
    return best
