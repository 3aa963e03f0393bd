"""Exact Hamming k-NN on packed guide codes: the packed-key contract, the
code packing that the CUDA kernels read, and the kernels' plain PyTorch
versions.

Keys: a (distance, database index) pair packs into one int32
``(dist << 24) | idx``.  Keys are unique per query, so selecting the k
smallest keys orders neighbors by (distance, index) with no tie left to
chance.  Sentinel keys (``>= INF_KEY``) unpack to (-1, -1).

Codes: a guide of L <= 32 bases packs into two 64-bit words, held as one
``(n, 2)`` int64 row: ``code`` has base i (A=0, C=1, G=2, T=3) at bits
2i..2i+1; ``valid`` has bit 2i set iff base i is A/C/G/T.  For a pair,
``x = qc ^ dc`` and ``eq = ~(x | x >> 1) & qv & dv`` hold one bit per
matching valid position, so ``dist = L - popcount(eq)``.  An N matches
nothing, not even another N, exactly as its all-zero one-hot row does in
the JAX package.

The plain versions count matches as a one-hot matrix product tile by tile,
an algorithm independent of the kernels' bit arithmetic.  They never hold
more than one (q tile x db tile) block.  The CPU runs them, and the tests
and ``chip_smoke.py`` hold the kernels against them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: bits reserved for the database index inside the packed int32 key.
IDX_BITS = 24
IDX_MASK = (1 << IDX_BITS) - 1
#: sentinel key larger than any real (dist, idx) pair.
INF_KEY = 1 << 30
#: largest database one key can index.
MAX_DB = 1 << IDX_BITS
#: longest guide the two 64-bit words hold.
MAX_LEN = 32
#: most neighbors returned per query (the JAX kernels' lane cap).
MAX_K = 128

_Q_TILE = 4096
_DB_TILE = 32768


def pack_keys(dist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(distance, db index) -> one int32 ascending sort key."""
    return (dist.to(torch.int32) << IDX_BITS) | idx.to(torch.int32)


def unpack_keys(keys: torch.Tensor):
    """Packed keys -> (dist, idx) int32; sentinel keys -> (-1, -1)."""
    invalid = keys >= INF_KEY
    dist = torch.where(invalid, -1, keys >> IDX_BITS).to(torch.int32)
    idx = torch.where(invalid, -1, keys & IDX_MASK).to(torch.int32)
    return dist, idx


def host_lists(keys: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Packed keys -> host (dist, idx), each (nq, k) int32, -1 beyond the
    keys' width."""
    dist, idx = (t.cpu().numpy() for t in unpack_keys(keys))
    if dist.shape[1] < k:
        pad = np.full((dist.shape[0], k - dist.shape[1]), -1, dtype=np.int32)
        dist = np.concatenate([dist, pad], axis=1)
        idx = np.concatenate([idx, pad], axis=1)
    return dist, idx


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 codes (A=0, C=1, G=2, T=3, other >= 4) -> (n, 2)
    int64 rows of (code word, valid word), on the codes' device."""
    n, length = codes.shape
    if length > MAX_LEN:
        raise ValueError(f"guides longer than {MAX_LEN} bases cannot be "
                         f"packed (got {length})")
    c = codes.to(torch.int64)
    valid = c < 4
    words = torch.zeros((n, 2), dtype=torch.int64, device=codes.device)
    for i in range(length):
        words[:, 0] |= torch.where(valid[:, i], c[:, i], 0) << (2 * i)
        words[:, 1] |= valid[:, i].to(torch.int64) << (2 * i)
    return words


def _onehot(words: torch.Tensor, length: int, dtype) -> torch.Tensor:
    """(n, 2) packed rows -> (n, 4L) one-hot; invalid bases are zero."""
    shifts = 2 * torch.arange(length, device=words.device)
    code = (words[:, :1] >> shifts) & 3
    valid = (words[:, 1:] >> shifts) & 1
    oh = torch.nn.functional.one_hot(code, 4) * valid[..., None]
    return oh.reshape(words.shape[0], 4 * length).to(dtype)


def _matmul_dtype(device: torch.device):
    # 0/1 products summed to at most 32 are exact in either type
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def hamming_count_plain(q: torch.Tensor, db: torch.Tensor, length: int,
                        editdist: int) -> torch.Tensor:
    """(nq,) int32: for each query, the database rows at Hamming distance
    < ``editdist`` (``matches > length - editdist``)."""
    dtype = _matmul_dtype(q.device)
    thresh = length - editdist
    q_oh = _onehot(q, length, dtype)
    out = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for lo in range(0, db.shape[0], _DB_TILE):
        d_oh = _onehot(db[lo:lo + _DB_TILE], length, dtype)
        for qlo in range(0, q.shape[0], _Q_TILE):
            m = q_oh[qlo:qlo + _Q_TILE] @ d_oh.T
            out[qlo:qlo + _Q_TILE] += (m > thresh).sum(1, dtype=torch.int32)
    return out


def hamming_topk_plain(q: torch.Tensor, db: torch.Tensor, length: int,
                       k: int) -> torch.Tensor:
    """(nq, min(k, nd, MAX_K)) int32 packed keys of each query's nearest
    database rows, ascending."""
    nd = db.shape[0]
    k_eff = min(k, nd, MAX_K)
    dtype = _matmul_dtype(q.device)
    out = torch.empty((q.shape[0], k_eff), dtype=torch.int32, device=q.device)
    for qlo in range(0, q.shape[0], _Q_TILE):
        q_oh = _onehot(q[qlo:qlo + _Q_TILE], length, dtype)
        best = torch.full((q_oh.shape[0], k_eff), INF_KEY, dtype=torch.int32,
                          device=q.device)
        for lo in range(0, nd, _DB_TILE):
            d_oh = _onehot(db[lo:lo + _DB_TILE], length, dtype)
            dist = length - (q_oh @ d_oh.T).to(torch.int32)
            idx = torch.arange(lo, lo + d_oh.shape[0], device=q.device)
            cand = torch.cat([best, pack_keys(dist, idx)], dim=1)
            best = torch.topk(cand, k_eff, dim=1, largest=False).values
        out[qlo:qlo + q_oh.shape[0]] = best
    return out
