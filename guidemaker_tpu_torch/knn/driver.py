"""Exact Hamming k-NN index over guide sequences, on one torch device.

The database is a code matrix, packed once into ``(n, 2)`` int64 rows that
stay resident on the index's device.  On a CUDA device every query and
retention pass runs the hand-written kernels of ``csrc/``; on the CPU it
runs their plain versions.  Distances are exact and tie-broken by database
index, so results do not depend on the device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import dna
from ..util import resolve_device
from . import stream
from .hamming import MAX_LEN, pack_codes, unpack_keys

#: backend names in an index saved by either package -> the port's device
_SAVED_BACKENDS = {"pallas": "cuda", "sharded": "cuda", "cuda": "cuda",
                   "xla": "cpu", "native": "cpu", "cpu": "cpu"}


class KnnIndex:
    """An exact nearest-neighbor index over equal-length guide sequences."""

    def __init__(self, seqs, metric: str = "hamming", device="cuda"):
        if len(seqs) == 0:
            raise ValueError("cannot build an index over zero sequences")
        if metric != "hamming":
            raise NotImplementedError(
                "Levenshtein indexes are not ported yet (ROADMAP.md, "
                "modules still to port: Levenshtein)")
        self.metric = "hamming"
        self.device = resolve_device(device)
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

    def _pack(self, codes: np.ndarray) -> torch.Tensor:
        return pack_codes(torch.from_numpy(codes).to(self.device))

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
        """query() on pre-encoded (nq, L) uint8 codes."""
        return self.hamming_query_codes(qc, k)

    def hamming_query_codes(self, qc: np.ndarray,
                            k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact Hamming k-NN on pre-encoded (nq, L) uint8 codes."""
        qc = np.ascontiguousarray(qc, dtype=np.uint8)
        nq = qc.shape[0]
        if nq == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.int32))
        keys = stream.hamming_topk(self._pack(qc), self._db, self.length, k)
        dist, idx = (t.cpu().numpy() for t in unpack_keys(keys))
        if dist.shape[1] < k:
            pad = np.full((nq, k - dist.shape[1]), -1, dtype=np.int32)
            dist = np.concatenate([dist, pad], axis=1)
            idx = np.concatenate([idx, pad], axis=1)
        return dist, idx

    def pass_distance_filter(self, seqs: Sequence[str],
                             editdist: int) -> np.ndarray:
        """(nq,) bool: does each query's 2nd-nearest neighbor (self is the
        1st; queries must be members of this index) sit at distance
        >= editdist?  The reference's guide-retention rule
        (guidemaker/core.py:509-522).

        Where the counting shortcut is exact it runs the count kernel, one
        pass per guide pair; otherwise it derives the answer from a k=2
        query.
        """
        if len(seqs) == 0:
            return np.zeros(0, dtype=bool)
        if self._n < 2:
            # reference semantics: dists[1] is padding (-1) -> nothing passes
            return np.zeros(len(seqs), dtype=bool)
        if editdist <= self.length and self._counting_filter_valid(seqs):
            if len(seqs) == self._n and self._seqs_equal_db(seqs):
                q = self._db        # all-vs-all: reuse the resident rows
            else:
                q = self._pack(self._encode_queries(seqs))
            counts = stream.hamming_count(q, self._db, self.length, editdist)
            # dists[1] >= editdist  <=>  count(dist < editdist) <= 1: for
            # editdist > 0 the self-hit always contributes exactly 1; for
            # editdist == 0 nothing does and every query passes (matching
            # the reference threshold, which is vacuous at 0)
            return (counts <= 1).cpu().numpy()
        dists, _ = self.query(seqs, k=2)
        return (dists[:, 1] >= 0) & (dists[:, 1] >= editdist)

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
    def load(cls, path: str, device=None) -> "KnnIndex":
        """Load an index saved by either package.  Without ``device``, a
        JAX backend name maps to the port's device: ``pallas`` and
        ``sharded`` (TPU kernels) to ``cuda``, ``xla`` and ``native``
        (portable and CPU engines) to ``cpu``."""
        z = np.load(path)
        if device is None:
            saved = str(z["backend"])
            if saved not in _SAVED_BACKENDS:
                raise ValueError(f"unknown saved backend {saved!r}")
            device = _SAVED_BACKENDS[saved]
        return cls(dna.decode_rows(z["codes"]), metric=str(z["metric"]),
                   device=device)
