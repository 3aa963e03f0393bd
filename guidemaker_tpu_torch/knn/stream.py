"""Wrappers of the hand-written CUDA count and top-k kernels (``csrc/``).

Named after the JAX package's ``knn/pallas_stream.py``, whose two
streaming kernels (count and top-k) ``hamming_count`` and ``hamming_topk``
replace.  The 2-D-grid top-k of ``pallas_hamming.py`` folds into the same
top-k kernel: its split from the streaming one existed only because of the
TPU's cost per grid step.  ``packed_count`` and ``packed_topk`` replace the
two kernels of ``pallas_packed.py``, on the packed-pair layout of
:mod:`.packed`.  ``feature_count`` replaces the count kernel where the
Levenshtein filter calls it on 3-gram features (:mod:`.features`), and
``leven_topk`` the JAX package's Myers top-k (``knn/leven.py``, XLA).

On a CPU tensor a wrapper runs its kernel's plain version
(:mod:`.hamming`, :mod:`.packed`, :mod:`.features`, :mod:`.dp`).  On a
CUDA tensor it launches the kernel on the current stream, without
synchronising, or raises.  Each wrapper
counts its launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import threading

import torch

from . import build
from .dp import leven_topk_plain
from .features import MAX_WORDS, feature_count_plain
from .hamming import (MAX_DB, MAX_K, MAX_LEN, hamming_count_plain,
                      hamming_topk_plain)
from .packed import (LANES, MAX_PACKED_LEN, packed_count_plain,
                     packed_topk_plain)


class LaunchCounter:
    """A thread-safe count of kernel launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.n = 0

    def add(self) -> None:
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0


count_launches = LaunchCounter()
topk_launches = LaunchCounter()
packed_count_launches = LaunchCounter()
packed_topk_launches = LaunchCounter()
feature_count_launches = LaunchCounter()
leven_topk_launches = LaunchCounter()

#: queries a block of every kernel
_Q_PER_BLOCK = 256
#: blocks the split choice aims to have in flight on each SM
_BLOCKS_PER_SM = 8
#: fewest database rows worth a split of their own
_MIN_SPLIT_ROWS = 1024


def _check(q: torch.Tensor, db: torch.Tensor, length: int) -> None:
    for name, t in (("q", q), ("db", db)):
        if t.dtype != torch.int64 or t.dim() != 2 or t.shape[1] != 2:
            raise ValueError(f"{name} must be (n, 2) int64 packed rows, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device != db.device:
        raise ValueError(f"q on {q.device} but db on {db.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not 1 <= length <= MAX_LEN:
        raise ValueError(f"guide length must be 1..{MAX_LEN}, got {length}")
    if not 1 <= db.shape[0] <= MAX_DB:
        raise ValueError(f"database must hold 1..{MAX_DB} rows, "
                         f"got {db.shape[0]}")


def _n_splits(nq: int, nd: int, device: torch.device) -> int:
    """Database splits that bring the grid to about ``_BLOCKS_PER_SM``
    blocks per SM, without splits smaller than ``_MIN_SPLIT_ROWS``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_blocks = -(-nq // _Q_PER_BLOCK)
    want = -(-_BLOCKS_PER_SM * sms // q_blocks)
    return max(1, min(want, -(-nd // _MIN_SPLIT_ROWS), 65535))


def hamming_count(q: torch.Tensor, db: torch.Tensor, length: int,
                  editdist: int) -> torch.Tensor:
    """(nq,) int32: database rows at Hamming distance < ``editdist`` from
    each query.  An N matches nothing; ``editdist`` 0 counts nothing."""
    _check(q, db, length)
    if not 0 <= editdist <= length:
        raise ValueError(f"editdist must be in 0..{length} for counting, "
                         f"got {editdist}")
    if q.device.type == "cpu":
        return hamming_count_plain(q, db, length, editdist)
    nq, nd = q.shape[0], db.shape[0]
    out = torch.zeros(nq, dtype=torch.int32, device=q.device)
    if nq == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.gm_hamming_count(
            q.data_ptr(), nq, db.data_ptr(), nd, length - editdist,
            _n_splits(nq, nd, q.device), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"hamming_count kernel launch failed: CUDA error "
                           f"{err}")
    count_launches.add()
    return out


def hamming_topk(q: torch.Tensor, db: torch.Tensor, length: int,
                 k: int) -> torch.Tensor:
    """(nq, min(k, nd, 128)) int32 packed keys ``(dist << 24) | idx`` of
    each query's nearest database rows, ascending."""
    _check(q, db, length)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if q.device.type == "cpu":
        return hamming_topk_plain(q, db, length, k)
    nq, nd = q.shape[0], db.shape[0]
    k_eff = min(k, nd, MAX_K)
    out = torch.empty((nq, k_eff), dtype=torch.int32, device=q.device)
    if nq == 0:
        return out
    kcap = 1 << (k_eff - 1).bit_length()
    n_splits = _n_splits(nq, nd, q.device)
    partial = torch.empty((nq, n_splits, kcap), dtype=torch.int32,
                          device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.gm_hamming_topk(
            q.data_ptr(), nq, db.data_ptr(), nd, length, k_eff, kcap,
            n_splits, partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"hamming_topk kernel launch failed: CUDA error "
                           f"{err}")
    topk_launches.add()
    return out


def _check_packed(q: torch.Tensor, db: torch.Tensor, nd: int,
                  length: int) -> None:
    for name, t in (("q", q), ("db", db)):
        if t.dtype != torch.int8 or t.dim() != 2 or t.shape[1] != LANES:
            raise ValueError(f"{name} must be (n, {LANES}) int8 packed-pair "
                             f"rows, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.device != db.device:
        raise ValueError(f"q on {q.device} but db on {db.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not 1 <= length <= MAX_PACKED_LEN:
        raise ValueError(f"packed guide length must be 1..{MAX_PACKED_LEN}, "
                         f"got {length}")
    if not 1 <= nd <= MAX_DB:
        raise ValueError(f"database must hold 1..{MAX_DB} guides, got {nd}")
    if db.shape[0] != -(-nd // 2):
        raise ValueError(f"{nd} guides need {-(-nd // 2)} packed rows, got "
                         f"{db.shape[0]}")


def packed_count(q: torch.Tensor, db: torch.Tensor, nd: int, length: int,
                 editdist: int) -> torch.Tensor:
    """(nq,) int32: database guides at Hamming distance < ``editdist`` from
    each query row, on the packed-pair layout (neither side may hold an
    N).  ``editdist`` 0 counts nothing."""
    _check_packed(q, db, nd, length)
    if not 0 <= editdist <= length:
        raise ValueError(f"editdist must be in 0..{length} for counting, "
                         f"got {editdist}")
    if q.device.type == "cpu":
        return packed_count_plain(q, db, nd, length, editdist)
    nq = q.shape[0]
    out = torch.zeros(nq, dtype=torch.int32, device=q.device)
    if nq == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.gm_packed_count(
            q.data_ptr(), nq, db.data_ptr(), nd, length, editdist,
            _n_splits(nq, db.shape[0], q.device), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_count kernel launch failed: CUDA error "
                           f"{err}")
    packed_count_launches.add()
    return out


def packed_topk(q: torch.Tensor, db: torch.Tensor, nd: int, length: int,
                k: int) -> torch.Tensor:
    """(nq, min(k, nd, 128)) int32 packed keys ``(dist << 24) | idx`` of
    each query row's nearest database guides, ascending, on the packed-pair
    layout (neither side may hold an N)."""
    _check_packed(q, db, nd, length)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if q.device.type == "cpu":
        return packed_topk_plain(q, db, nd, length, k)
    nq = q.shape[0]
    k_eff = min(k, nd, MAX_K)
    out = torch.empty((nq, k_eff), dtype=torch.int32, device=q.device)
    if nq == 0:
        return out
    kcap = 1 << (k_eff - 1).bit_length()
    n_splits = _n_splits(nq, db.shape[0], q.device)
    partial = torch.empty((nq, n_splits, kcap), dtype=torch.int32,
                          device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.gm_packed_topk(
            q.data_ptr(), nq, db.data_ptr(), nd, length, k_eff, kcap,
            n_splits, partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_topk kernel launch failed: CUDA error "
                           f"{err}")
    packed_topk_launches.add()
    return out


def _check_features(q: torch.Tensor, db: torch.Tensor, n_words: int) -> None:
    if not 1 <= n_words <= MAX_WORDS:
        raise ValueError(f"feature rows must have 1..{MAX_WORDS} words, got "
                         f"{n_words}")
    for name, t in (("q", q), ("db", db)):
        if t.dtype != torch.int64 or t.dim() != 2 or t.shape[1] != n_words:
            raise ValueError(f"{name} must be (n, {n_words}) int64 feature "
                             f"rows, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device != db.device:
        raise ValueError(f"q on {q.device} but db on {db.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not 1 <= db.shape[0] <= MAX_DB:
        raise ValueError(f"database must hold 1..{MAX_DB} rows, "
                         f"got {db.shape[0]}")


def feature_count(q_rows: torch.Tensor, db_rows: torch.Tensor, n_words: int,
                  thresh: int) -> torch.Tensor:
    """(nq,) int32: database rows whose feature dot with each query row
    exceeds ``thresh``; rows are (n, n_words) int64 bit-packed 0/1
    features (:func:`.features.gram_rows`)."""
    _check_features(q_rows, db_rows, n_words)
    if not 0 <= thresh <= 64 * n_words:
        raise ValueError(f"thresh must be in 0..{64 * n_words}, got {thresh}")
    if q_rows.device.type == "cpu":
        return feature_count_plain(q_rows, db_rows, thresh)
    nq, nd = q_rows.shape[0], db_rows.shape[0]
    out = torch.zeros(nq, dtype=torch.int32, device=q_rows.device)
    if nq == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q_rows.device):
        err = lib.gm_feature_count(
            q_rows.data_ptr(), nq, db_rows.data_ptr(), nd, n_words, thresh,
            _n_splits(nq, nd, q_rows.device), out.data_ptr(),
            torch.cuda.current_stream(q_rows.device).cuda_stream)
    if err:
        raise RuntimeError(f"feature_count kernel launch failed: CUDA error "
                           f"{err}")
    feature_count_launches.add()
    return out


def leven_topk(q: torch.Tensor, db: torch.Tensor, length: int,
               k: int) -> torch.Tensor:
    """(nq, min(k, nd)) int32 packed keys ``(dist << 24) | idx`` of each
    query's nearest database rows by Levenshtein distance, ascending, on
    (n, 2) packed rows.  An N matches nothing.  ``k`` above 128, the
    kernel's list, raises rather than returning fewer neighbors."""
    _check(q, db, length)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    if q.device.type == "cpu":
        return leven_topk_plain(q, db, length, k)
    nq, nd = q.shape[0], db.shape[0]
    k_eff = min(k, nd)
    out = torch.empty((nq, k_eff), dtype=torch.int32, device=q.device)
    if nq == 0:
        return out
    kcap = 1 << (k_eff - 1).bit_length()
    n_splits = _n_splits(nq, nd, q.device)
    partial = torch.empty((nq, n_splits, kcap), dtype=torch.int32,
                          device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.gm_leven_topk(
            q.data_ptr(), nq, db.data_ptr(), nd, length, k_eff, kcap,
            n_splits, partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"leven_topk kernel launch failed: CUDA error "
                           f"{err}")
    leven_topk_launches.add()
    return out
