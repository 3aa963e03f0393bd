"""Exact k-NN index over guide sequences (Hamming or Levenshtein), on one
torch device.

The database is a code matrix, packed once into ``(n, 2)`` int64 rows that
stay resident on the index's device, whatever the metric.  On a CUDA device
every query and retention pass runs the hand-written kernels of ``csrc/``;
on the CPU it runs their plain versions.  Distances are exact and
tie-broken by database index, so results do not depend on the device.
The metric governs :meth:`KnnIndex.query` and retention; the control
search's counts and k=1 queries are Hamming on either metric.

The packed-pair layout (:mod:`.packed`, two guides per 128-lane int8 row)
is an opt-in, as in the JAX package: ``packed=True``, or
``GUIDEMAKER_TPU_PACKED`` set in the environment, for guides of at most 21
bases.  It gives the same answers through its own two kernels.  It is
used only for N-free data: a database with an N keeps the 2-bit layout,
and a call whose queries hold an N takes the 2-bit kernels (the N gate).
"""
from __future__ import annotations

import logging
import os
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import dna
from ..util import resolve_device
from . import packed as pk
from . import stream
from .hamming import MAX_LEN, pack_codes, unpack_keys
from .leven import leven_pass_filter

logger = logging.getLogger(__name__)

#: backend names in an index saved by either package -> the port's device
_SAVED_BACKENDS = {"pallas": "cuda", "sharded": "cuda", "cuda": "cuda",
                   "xla": "cpu", "native": "cpu", "cpu": "cpu"}

#: query rows per count launch: bounds the transient query rows of a large
#: candidate set (128 bytes a guide when packed: 256 MiB)
_COUNT_CHUNK = 1 << 21


def use_packed(length: int) -> bool:
    """The JAX package's opt-in: ``GUIDEMAKER_TPU_PACKED`` is set and the
    guides fit the packed layout."""
    return (length <= pk.MAX_PACKED_LEN
            and bool(os.environ.get("GUIDEMAKER_TPU_PACKED")))


def _device_for(device, backend):
    """The index's device from the port's ``device`` and a JAX ``backend``
    name (mapped through ``_SAVED_BACKENDS``); the card when neither is
    given.  Raises ``ValueError`` on an unknown backend or when the two
    name different device types."""
    if backend is None:
        return resolve_device("cuda" if device is None else device)
    if backend not in _SAVED_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: "
                         f"{sorted(_SAVED_BACKENDS)}")
    mapped = _SAVED_BACKENDS[backend]
    if device is None:
        return resolve_device(mapped)
    if torch.device(device).type != mapped:
        raise ValueError(f"backend {backend!r} runs on {mapped}, but device "
                         f"{device!r} was given")
    return resolve_device(device)


class KnnIndex:
    """An exact nearest-neighbor index over equal-length guide sequences.

    ``metric`` is ``"hamming"`` or ``"leven"`` (Levenshtein).  ``device``
    defaults to ``"cuda"``; ``backend`` takes the JAX package's backend
    names instead (``pallas``/``sharded`` -> cuda, ``xla``/``native`` ->
    cpu) and must agree with ``device`` when both are given.
    ``num_threads`` (the JAX native engine's) is accepted and ignored.
    ``packed`` selects the packed-pair layout of the Hamming calls
    (``None``: read ``GUIDEMAKER_TPU_PACKED``, as the JAX package does);
    ``True`` with guides longer than 21 bases raises.
    """

    def __init__(self, seqs, metric: str = "hamming", device=None,
                 packed=None, backend: str = None, num_threads: int = 0):
        if len(seqs) == 0:
            raise ValueError("cannot build an index over zero sequences")
        if metric not in ("hamming", "leven"):
            raise ValueError(f"metric must be 'hamming' or 'leven', got "
                             f"{metric!r}")
        self.metric = metric
        self.device = _device_for(device, backend)
        if isinstance(seqs, (list, tuple)):
            self._seqs_list: List[str] = list(seqs)
            self._seq_arr = None     # Arrow form built lazily on demand
            self.length = len(self._seqs_list[0])
            for s in self._seqs_list:
                if len(s) != self.length:
                    raise ValueError(
                        "all indexed sequences must share one length")
            codes = dna.encode_batch(self._seqs_list, self.length)
        else:
            # pandas / pyarrow column: codes come straight off the Arrow
            # data buffer; Python strings are built only if `.seqs` is read
            self._seqs_list = None
            codes, self._seq_arr = dna.encode_pandas(seqs)
            self.length = codes.shape[1]
        if self.length > MAX_LEN:
            raise ValueError(f"guides longer than {MAX_LEN} bases are not "
                             f"supported (got {self.length})")
        self._n = codes.shape[0]
        self._codes = codes.astype(np.uint8)
        self._db = self._pack(self._codes)
        self._seqset = None   # frozenset(self.seqs), built on first use
        self._dedup_ok = None  # Arrow-path dedup validity, built on first use
        if packed is None:
            packed = use_packed(self.length)
        elif packed and self.length > pk.MAX_PACKED_LEN:
            raise ValueError(f"the packed layout holds guides of at most "
                             f"{pk.MAX_PACKED_LEN} bases (got {self.length})")
        #: the packed-pair layout is in use (opted in, database N-free)
        self.packed = bool(packed) and int(self._codes.max(initial=0)) < 4
        if packed and not self.packed:
            logger.info("packed layout off for this index: the database "
                        "holds N bases, which only the 2-bit kernels match")
        self._db_packed = None    # (ceil(n/2), 128) int8, built on first use
        self._logged_query_n = False
        # the control search's thread calls the index beside the main one
        self._lock = threading.Lock()

    def _pack(self, codes: np.ndarray) -> torch.Tensor:
        return pack_codes(torch.from_numpy(codes).to(self.device))

    def _packed_db(self) -> torch.Tensor:
        """The packed-pair database rows, built once on the device."""
        if self._db_packed is None:
            with self._lock:
                if self._db_packed is None:
                    self._db_packed = pk.db_rows(
                        torch.from_numpy(self._codes).to(self.device))
        return self._db_packed

    def _packed_for(self, q: torch.Tensor) -> bool:
        """The N gate: does a call on these (nq, L) codes take the packed
        kernels?  Only in the packed layout and with N-free queries."""
        if not self.packed:
            return False
        if bool((q >= 4).any()):
            with self._lock:
                log, self._logged_query_n = not self._logged_query_n, True
            if log:
                logger.info("queries with N bases take the 2-bit kernels "
                            "on this packed index")
            return False
        return True

    def _as_codes(self, codes) -> torch.Tensor:
        """Host codes or a device uint8 tensor -> (nq, L) on the device."""
        if not torch.is_tensor(codes):
            codes = torch.from_numpy(np.ascontiguousarray(codes,
                                                          dtype=np.uint8))
        return codes.to(self.device)

    def _count(self, q: torch.Tensor, editdist: int) -> torch.Tensor:
        """(nq,) int32 counts, on the device, of database guides at Hamming
        distance < ``editdist`` from each of the (nq, L) codes ``q``, in
        launches of at most ``_COUNT_CHUNK`` queries."""
        packed = self._packed_for(q)
        parts = []
        for lo in range(0, max(q.shape[0], 1), _COUNT_CHUNK):
            part = q[lo:lo + _COUNT_CHUNK]
            if packed:
                parts.append(stream.packed_count(
                    pk.query_rows(part), self._packed_db(), self._n,
                    self.length, editdist))
            else:
                parts.append(stream.hamming_count(
                    pack_codes(part), self._db, self.length, editdist))
        return torch.cat(parts)

    @property
    def seqs(self) -> List[str]:
        """Indexed sequences as a Python list (materialized lazily)."""
        if self._seqs_list is None:
            self._seqs_list = self._seq_arr.to_pylist()
        return self._seqs_list

    @property
    def seq_array(self):
        """Indexed sequences as a pyarrow StringArray (built from the code
        matrix when the index was constructed from a list)."""
        if self._seq_arr is None:
            import pyarrow as pa
            arr = dna.rows_to_str_array(self._codes)
            self._seq_arr = pa.array(arr, from_pandas=True)
        return self._seq_arr

    def _counting_filter_valid(self, seqs) -> bool:
        """True iff the counting retention shortcut is exact for these
        queries: the database must be duplicate-free and every query a
        member (so the self-hit contributes exactly one count).  Otherwise
        retention takes the k=2 path, which implements the general rule."""
        if not isinstance(seqs, (list, tuple)):
            import pyarrow as pa
            import pyarrow.compute as pc
            if self._dedup_ok is None:
                self._dedup_ok = bool(
                    len(self.seq_array.unique()) == self._n)
            if not self._dedup_ok:
                return False
            qa = seqs if isinstance(seqs, pa.Array) \
                else pa.array(seqs, from_pandas=True)
            if qa is self._seq_arr or len(qa) == 0:
                return True
            return bool(pc.all(pc.is_in(
                qa, value_set=self.seq_array)).as_py())
        if self._seqset is None:
            self._seqset = frozenset(self.seqs)
        if len(self._seqset) != self._n:
            return False
        if len(seqs) == self._n and list(seqs) == self.seqs:
            return True
        return all(s in self._seqset for s in seqs)

    def __len__(self) -> int:
        return self._n

    def _encode_queries(self, seqs) -> np.ndarray:
        if isinstance(seqs, (list, tuple)):
            return dna.encode_batch(seqs, self.length)
        codes, _ = dna.encode_pandas(seqs, self.length)
        return codes

    def _seqs_equal_db(self, seqs) -> bool:
        """Query batch == the whole database, in order (the all-vs-all
        retention then reuses the resident database rows)."""
        if isinstance(seqs, (list, tuple)):
            return list(seqs) == self.seqs
        if seqs is self._seq_arr:
            return True
        import pyarrow as pa
        import pyarrow.compute as pc
        qa = seqs if isinstance(seqs, pa.Array) \
            else pa.array(seqs, from_pandas=True)
        return bool(pc.all(pc.equal(qa, self.seq_array)).as_py())

    def query(self, seqs: Sequence[str],
              k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest database entries for each query sequence.

        Returns (dists, idx), each (nq, k) int32, ascending by (distance,
        database index); -1 padding beyond min(k, len(db), 128).
        """
        if len(seqs) == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.int32))
        return self.query_codes(self._encode_queries(seqs), k)

    def query_codes(self, qc: np.ndarray,
                    k: int) -> Tuple[np.ndarray, np.ndarray]:
        """query() on pre-encoded (nq, L) uint8 codes, by the index's
        metric.  A Levenshtein query takes k <= 128."""
        if self.metric == "hamming":
            return self.hamming_query_codes(qc, k)
        if qc.shape[0] == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.int32))
        keys = stream.leven_topk(pack_codes(self._as_codes(qc)), self._db,
                                 self.length, k)
        return _host_lists(keys, k)

    def hamming_query_codes(self, qc: np.ndarray,
                            k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact Hamming k-NN on pre-encoded (nq, L) uint8 codes, on either
        metric (the control search's rule is Hamming by definition)."""
        if qc.shape[0] == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.int32))
        q = self._as_codes(qc)
        if self._packed_for(q):
            keys = stream.packed_topk(pk.query_rows(q), self._packed_db(),
                                      self._n, self.length, k)
        else:
            keys = stream.hamming_topk(pack_codes(q), self._db, self.length,
                                       k)
        return _host_lists(keys, k)

    def pass_distance_filter(self, seqs: Sequence[str],
                             editdist: int) -> np.ndarray:
        """(nq,) bool: does each query's 2nd-nearest neighbor (self is the
        1st; queries must be members of this index) sit at distance
        >= editdist?  The reference's guide-retention rule
        (guidemaker/core.py:509-522).

        Where the counting shortcut is exact it runs a count kernel, one
        pass per guide pair (on a Levenshtein index, the tiers of
        :func:`.leven.leven_pass_filter`); otherwise it derives the answer
        from a k=2 query.
        """
        if len(seqs) == 0:
            return np.zeros(0, dtype=bool)
        if self._n < 2:
            # reference semantics: dists[1] is padding (-1) -> nothing passes
            return np.zeros(len(seqs), dtype=bool)
        if editdist <= self.length and self._counting_filter_valid(seqs):
            all_vs_all = len(seqs) == self._n and self._seqs_equal_db(seqs)
            if self.metric == "leven":
                db = self._as_codes(self._codes)
                q = db if all_vs_all else self._as_codes(
                    self._encode_queries(seqs))
                return leven_pass_filter(q, db, editdist).cpu().numpy()
            # all-vs-all: no re-encoding
            qc = self._codes if all_vs_all else self._encode_queries(seqs)
            counts = self._count(self._as_codes(qc), editdist)
            # dists[1] >= editdist  <=>  count(dist < editdist) <= 1: for
            # editdist > 0 the self-hit always contributes exactly 1; for
            # editdist == 0 nothing does and every query passes (matching
            # the reference threshold, which is vacuous at 0)
            return (counts <= 1).cpu().numpy()
        dists, _ = self.query(seqs, k=2)
        return (dists[:, 1] >= 0) & (dists[:, 1] >= editdist)

    # ------------------------------------------------------------------
    # counting triage of the control-guide search
    # ------------------------------------------------------------------
    def count_within(self, codes, editdist: int):
        """(nq,) int32 host counts of database guides at HAMMING distance
        < ``editdist`` from each of the (nq, L) ``codes`` (host array or
        device uint8 tensor), or None when ``editdist > L`` (callers then
        take an exact k=1 query).

        Unlike :meth:`pass_distance_filter`, no membership precondition:
        ``count == 0`` <=> the Hamming nearest is >= ``editdist``.
        """
        if editdist > self.length:
            return None
        return self._count(self._as_codes(codes), editdist).cpu().numpy()

    def pass_mask_within(self, codes, editdist: int):
        """(nq,) uint8 host mask, 1 iff NO database guide lies at Hamming
        distance < ``editdist`` from the candidate (the control ladder's
        triage decision), or None when ``editdist > L``.  The counts
        reduce to the mask on the device; one transfer brings it back."""
        if editdist > self.length:
            return None
        counts = self._count(self._as_codes(codes), editdist)
        return (counts == 0).to(torch.uint8).cpu().numpy()

    def supports_chunk_triage(self, editdist: int) -> bool:
        """True iff :meth:`pass_mask_chunks` runs: the 2-bit layout and a
        countable ``editdist``.  The control ladder picks its path once
        with it; the packed layout takes the monolithic rung, as in the
        JAX package."""
        return not self.packed and editdist <= self.length

    def pass_mask_chunks(self, chunks, editdist: int):
        """:meth:`pass_mask_within` over a list of device candidate chunks,
        as one uint8 host mask over all their rows in order, or None when
        :meth:`supports_chunk_triage` is false."""
        if not self.supports_chunk_triage(editdist):
            return None
        masks = [(self._count(c, editdist) == 0) for c in chunks]
        return torch.cat(masks).to(torch.uint8).cpu().numpy()

    def neighbor_seqs(self, idx_row: np.ndarray) -> List[str]:
        """Map database indices to sequences."""
        return [self.seqs[int(i)] for i in idx_row if int(i) >= 0]

    # ------------------------------------------------------------------
    # persistence: the same .npz layout as guidemaker_tpu's KnnIndex.save
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Save the index to an .npz file (codes + metric + backend)."""
        np.savez_compressed(path, codes=self._codes,
                            metric=np.str_(self.metric),
                            backend=np.str_(self.device.type))

    @classmethod
    def load(cls, path: str, device=None, backend: str = None) -> "KnnIndex":
        """Load an index saved by either package.  Without ``device`` or
        ``backend``, the saved backend name maps to the port's device:
        ``pallas`` and ``sharded`` (TPU kernels) to ``cuda``, ``xla`` and
        ``native`` (portable and CPU engines) to ``cpu``.  ``backend``
        maps the same way and must agree with ``device``."""
        z = np.load(path)
        if device is None and backend is None:
            backend = str(z["backend"])
        return cls(dna.decode_rows(z["codes"]), metric=str(z["metric"]),
                   device=device, backend=backend)


def knn_search(db_seqs: Sequence[str], q_seqs: Sequence[str], k: int,
               metric: str = "hamming",
               device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """One-shot exact k-NN: build an index over ``db_seqs`` on ``device``
    and query it; (dists, idx), each (nq, k) int32, as
    :meth:`KnnIndex.query`."""
    return KnnIndex(db_seqs, metric, device=device).query(q_seqs, k)


def _host_lists(keys: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Packed keys -> host (dist, idx), each (nq, k) int32, -1 beyond the
    keys' width."""
    dist, idx = (t.cpu().numpy() for t in unpack_keys(keys))
    if dist.shape[1] < k:
        pad = np.full((dist.shape[0], k - dist.shape[1]), -1, dtype=np.int32)
        dist = np.concatenate([dist, pad], axis=1)
        idx = np.concatenate([idx, pad], axis=1)
    return dist, idx
