"""Guide pool processing: filters and exact off-target k-NN.

Equivalent of the reference's ``TargetProcessor``
(``guidemaker/core.py:295-633``) with the same public methods and
semantics, the NMSLib HNSW index replaced by the exact k-NN index of
:mod:`guidemaker_tpu_torch.knn`, which runs on the processor's device.

Deliberate fixes vs the reference (documented, all strictly stronger):

* the index is built over the *first-occurrence-ordered* deduplicated
  target list instead of hash-ordered ``list(set(...))`` (core.py:446) —
  results are deterministic;
* reported "Similar guides" strings are looked up in the index's own
  ordering (the reference indexed the full targets column with dedup-set
  indices — core.py:513 — making those strings unreliable).

The control-guide search is not ported yet (ROADMAP.md, modules still to
port: controls); its methods raise ``NotImplementedError``.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import yaml

from . import dna
from .knn import KnnIndex

logger = logging.getLogger(__name__)

pd.options.mode.chained_assignment = None

_CONTROLS_NOT_PORTED = ("the control-guide search is not ported yet "
                        "(ROADMAP.md, modules still to port: controls); "
                        "run with controls=0 (--controls 0)")


class TargetProcessor:
    """A set of candidate gRNA targets plus processing state."""

    def __init__(self, targets: pd.DataFrame, lsr: int, editdist: int = 2,
                 knum: int = 2, device="cuda") -> None:
        self.targets = targets
        self.lsr: int = lsr
        self.editdist: int = editdist
        self.knum: int = knum
        self.device = device
        self.index: Optional[KnnIndex] = None
        self._nb_pass_seqs: List[str] = []
        self._nb_dists: Optional[np.ndarray] = None  # (npass, k) int32
        self._nb_idxs: Optional[np.ndarray] = None   # (npass, k) int32
        self._neighbors_cache: Optional[Dict] = None
        self.pam_orientation: bool = bool(targets["pam_orientation"].iat[0])

    # `nmslib_index` name kept for API compatibility with the reference.
    @property
    def nmslib_index(self):
        return self.index

    def __str__(self) -> str:
        return "TargetList: contains a set of {} potential PAM targets".format(
            len(self.targets))

    def __len__(self) -> int:
        return len(self.targets)

    # ------------------------------------------------------------------
    def check_restriction_enzymes(self, restriction_enzyme_list: list = None) -> None:
        """Flag guides containing a restriction site or its reverse complement.

        Matches reference behavior (core.py:354-377): rows are *flagged*,
        never dropped; the flag feeds the neighbor-query filter.
        """
        if restriction_enzyme_list is None:
            restriction_enzyme_list = []
        element_to_exclude: List[str] = []
        for record in set(restriction_enzyme_list):
            for letter in record.upper():
                assert letter in set("ACGTMRWSYKVHDBXN")
            element_to_exclude.extend(dna.extend_ambiguous_dna(record.upper()))
            element_to_exclude.extend(
                dna.extend_ambiguous_dna(dna.reverse_complement(record.upper())))
        if element_to_exclude:
            pattern = re.compile("|".join(element_to_exclude))
            self.targets["hasrestrictionsite"] = self.targets["target"].apply(
                lambda s: bool(pattern.search(s)))
        else:
            self.targets["hasrestrictionsite"] = False

    # ------------------------------------------------------------------
    def find_unique_near_pam(self) -> None:
        """Mark targets whose PAM-proximal seed region is duplicated.

        Seed = first ``lsr`` bases for 5prime PAMs, last ``lsr`` for 3prime;
        ``lsr == 0`` means the whole guide (core.py:388-416).  First
        occurrence is kept (pandas ``duplicated`` default).
        """
        lsr = self.lsr
        self.targets = self.targets.copy()
        tcol = self.targets["target"]
        if lsr == 0:
            seed = tcol.copy()
        elif self.pam_orientation:            # 5prime
            seed = tcol.str.slice(0, lsr)
        else:                                 # 3prime
            seed = tcol.str.slice(-lsr)
        self.targets.loc[:, "seedseq"] = seed
        self.targets.loc[:, "isseedduplicated"] = seed.duplicated()

    # ------------------------------------------------------------------
    def create_index(self, configpath: str = None, num_threads: int = 2) -> None:
        """Build the exact k-NN index over the deduplicated target set.

        ``configpath``/``num_threads`` are accepted for reference CLI/API
        compatibility; the exact engine has no recall hyperparameters.
        """
        if configpath is not None:
            with open(configpath) as cf:
                yaml.safe_load(cf)  # validated for parity; no knobs needed
        # pd.unique keeps first-occurrence order, and the index encodes
        # straight off the Arrow buffer (no Python string list)
        notduplicated_targets = pd.unique(self.targets["target"])
        metric = str(self.targets["dtype"].iat[0])
        metric = "hamming" if metric == "hamming" else "leven"
        logger.info("Building exact %s k-NN index over %d unique targets",
                    metric, len(notduplicated_targets))
        self.index = KnnIndex(notduplicated_targets, metric=metric,
                              device=self.device)

    # ------------------------------------------------------------------
    def get_neighbors(self, configpath: str = None, num_threads: int = 2) -> None:
        """Retention for all seed-unique-or-restriction-free targets.

        Keeps a query iff its second-nearest neighbor (hit 0 is self) is at
        least ``editdist`` away — the reference's thresholding at
        core.py:509-522.  The reference's ``|`` (OR) query filter at
        core.py:495 is replicated verbatim.  The k-NN lists themselves are
        computed later, and only for the guides the table keeps.
        """
        mask = ((self.targets["isseedduplicated"] == False)  # noqa: E712
                | (self.targets["hasrestrictionsite"] == False))  # noqa: E712
        query_seqs = self.targets.loc[mask, "target"].drop_duplicates()
        pass_mask = self.index.pass_distance_filter(query_seqs,
                                                    self.editdist)
        self._neighbors_cache = None
        self._nb_pass_seqs = query_seqs[np.asarray(pass_mask)].tolist()
        self._nb_dists = None   # lazy; see _neighbor_arrays()
        self._nb_idxs = None
        logger.info("%d of %d queried targets passed the distance filter",
                    len(self._nb_pass_seqs), len(query_seqs))

    def _neighbor_arrays(self):
        """k-NN (dists, idxs) for all passing queries, computed on first
        use (the raw-guides path never needs them at all)."""
        if self._nb_dists is None:
            if self._nb_pass_seqs:
                self._nb_dists, self._nb_idxs = self.index.query(
                    self._nb_pass_seqs, k=self.knum)
            else:
                self._nb_dists = np.empty((0, self.knum), np.int32)
                self._nb_idxs = np.empty((0, self.knum), np.int32)
        return self._nb_dists, self._nb_idxs

    # ------------------------------------------------------------------
    @property
    def neighbors(self) -> Dict:
        """Reference-shaped neighbor dict
        ``{queryseq: {target, neighbors: {seqs, dist}}}`` (core.py:504-523),
        materialized lazily from the array results."""
        if self._neighbors_cache is None:
            neighbor_dict: Dict = {}
            if len(self._nb_pass_seqs):
                nb_dists, nb_idxs = self._neighbor_arrays()
                dlist = nb_dists.tolist()
                ilist = nb_idxs.tolist()
                db_seqs = self.index.seqs
                for qi, queryseq in enumerate(self._nb_pass_seqs):
                    drow = [d for d in dlist[qi] if d >= 0]
                    neighbor_dict[queryseq] = {
                        "target": queryseq,
                        "neighbors": {
                            "seqs": [db_seqs[j]
                                     for j in ilist[qi][:len(drow)]],
                            "dist": drow,
                        },
                    }
            self._neighbors_cache = neighbor_dict
        return self._neighbors_cache

    @neighbors.setter
    def neighbors(self, value: Dict) -> None:
        self._neighbors_cache = value
        self._nb_pass_seqs = list(value.keys())
        # drop materialized arrays: they are indexed by the old key order
        self._nb_dists = None
        self._nb_idxs = None

    def passing_seqs(self) -> List[str]:
        """Query sequences that passed the distance filter (dict keys)."""
        return self._nb_pass_seqs

    def neighbor_frame(self, seqs) -> pd.DataFrame:
        """Vectorized ``Similar guides`` / ``Similar guide distances``
        columns for the given guide sequences (must be passing seqs).

        Equivalent to joining ``neighbors[seq]['neighbors']`` with ';'
        (core.py:929-931) but only materializes strings for the guides
        that survive annotation filtering.
        """
        from .util import substage_timer
        seqs = list(seqs)
        if self._nb_dists is not None:
            pos = pd.Index(self._nb_pass_seqs).get_indexer(seqs)
            if (pos < 0).any():
                missing = [s for s, p in zip(seqs, pos) if p < 0][:3]
                raise KeyError(f"sequences not in neighbor results: {missing}")
            d = self._nb_dists[pos]
            i = self._nb_idxs[pos]
        else:
            # lazy phase 2: k-NN lists only for the guides actually kept
            with substage_timer("nbframe: phase-2 query n=%d" % len(seqs)):
                d, i = self.index.query(seqs, k=self.knum)
        # Arrow's elementwise join with null_handling='skip' reproduces the
        # truncate-at-first-invalid semantics (invalid (-1) entries are a
        # suffix: distances sort ascending and -1 only pads k > db rows)
        import pyarrow as pa
        import pyarrow.compute as pc
        with substage_timer("nbframe: arrow assembly"):
            valid = d >= 0
            db_arr = self.index.seq_array   # Arrow, no Python strings
            if pa.types.is_large_string(db_arr.type):
                # the ';' literal below binds as `string`; the elementwise
                # join kernel wants uniform types
                db_arr = db_arr.cast(pa.string())
            seq_cols, dist_cols = [], []
            for c in range(d.shape[1]):
                v = pa.array(valid[:, c])
                idx = pc.if_else(v, pa.array(i[:, c].astype(np.int32)),
                                 pa.scalar(None, pa.int32()))
                seq_cols.append(pc.take(db_arr, idx))
                dist_cols.append(pc.if_else(
                    v, pc.cast(pa.array(d[:, c].astype(np.int32)), pa.string()),
                    pa.scalar(None, pa.string())))
            # column 0 must never be null: the Arrow join DROPS (not
            # empties) all-null rows, which would misalign the frame
            seq_cols[0] = pc.fill_null(seq_cols[0], "")
            dist_cols[0] = pc.fill_null(dist_cols[0], "")
            seq_strs = pc.binary_join_element_wise(
                *seq_cols, ";", null_handling="skip")
            dist_strs = pc.binary_join_element_wise(
                *dist_cols, ";", null_handling="skip")
        return pd.DataFrame({
            "Guide sequence": list(seqs),
            "Similar guides": seq_strs.to_pylist(),
            "Similar guide distances": dist_strs.to_pylist(),
        })

    # ------------------------------------------------------------------
    def export_bed(self) -> pd.DataFrame:
        """Seed-unique targets as a sorted 5-column BED-like frame
        (core.py:525-543)."""
        df = self.targets.loc[self.targets["isseedduplicated"] == False].copy()  # noqa: E712
        df = df[["seqid", "start", "stop", "target", "strand"]]
        df = df.assign(strand=np.where(df["strand"], "+", "-"))
        df.columns = ["chrom", "chromstart", "chromend", "name", "strand"]
        df = df.astype({"chrom": "str"})
        df.sort_values(by=["chrom", "chromstart"], inplace=True)
        return df

    # ------------------------------------------------------------------
    def launch_control_search(self, *args, **kwargs):
        """Not ported yet: raises ``NotImplementedError``."""
        raise NotImplementedError(_CONTROLS_NOT_PORTED)

    def get_control_seqs(self, *args, **kwargs):
        """Not ported yet: raises ``NotImplementedError``."""
        raise NotImplementedError(_CONTROLS_NOT_PORTED)
