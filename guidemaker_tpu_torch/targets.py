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
  indices — core.py:513 — making those strings unreliable);
* control search succeeding on the last escalation rung returns instead of
  raising ``IndexError`` (reference loop condition quirk, core.py:586).
"""
from __future__ import annotations

import hashlib
import logging
import re
import statistics
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import torch
import yaml

from . import dna
from .io.records import record_id_and_seq
from .knn import KnnIndex

logger = logging.getLogger(__name__)

pd.options.mode.chained_assignment = None

#: sampled codes per inverse-CDF cell, in the reference's G, C, A, T order
_SAMPLE_BASES = torch.tensor([dna.G, dna.C, dna.A, dna.T], dtype=torch.uint8)

#: chunks triaged per round in the control search: the early-exit
#: granularity
_TRIAGE_GROUP = 2


def _control_chunk_rows(device: torch.device) -> int:
    """Candidate rows per sampled chunk of the control ladder.

    On the card, 2^19 rows: one chunk is 0.6e12 pairs against a 1.16 M-guide
    genome, a fraction of a second of counting, so a triage group of two
    bounds the work past the point where the search could stop, and the
    chunk's transients (its codes, float draws and counts) stay near
    100 MB.  On the CPU, 2^13 rows, as the JAX package has it off the TPU,
    so the tests stay fast.  The value decides which chunks the rungs
    draw: seeded controls are reproducible per (device type, chunk rows).
    """
    return (1 << 19) if device.type == "cuda" else (1 << 13)


def _chunk_seed(seed: int, rung: int, chunk: int) -> int:
    """A 64-bit generator seed for one chunk of one rung."""
    return int(np.random.SeedSequence([seed, rung, chunk]).generate_state(
        1, np.uint64)[0])


def _sample_chunk(seed: int, rung: int, chunk: int, cum: torch.Tensor,
                  m: int, length: int, device: torch.device) -> torch.Tensor:
    """One chunk of control candidates: (m, length) uint8 codes drawn on
    ``device`` from a ``torch.Generator`` seeded from (seed, rung, chunk),
    as the JAX package folds (rung, chunk) into its key.

    The inverse CDF over G, C, A, T is the JAX package's: a float32 uniform
    u falls in cell ``sum(u >= cum)`` of the float32 cumulative
    frequencies ``cum``.  Philox (CUDA) and the CPU generator give other
    streams than threefry and than each other, so seeded controls differ
    between devices and from the JAX package's.
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(_chunk_seed(seed, rung, chunk))
    u = torch.rand((m, length), generator=gen, device=device,
                   dtype=torch.float32)
    cell = (u[..., None] >= cum).sum(-1).clamp_(max=3)
    return _SAMPLE_BASES.to(device)[cell]


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
        self.ncontrolsearched: Optional[int] = None
        self.gc_percent: Optional[float] = None
        self.genomesize: Optional[float] = None
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
    def _control_search(self, gc: float, length: int, n: int,
                        multiples, minimum_hmdist_target: int,
                        seed: Optional[int]):
        """The escalation-ladder search (core.py:586-623), on the device.

        * candidates are sampled on the index's device in fixed
          ``_control_chunk_rows`` chunks (:func:`_sample_chunk`);
        * the triage counts every candidate against the genome: it passes
          iff count(dist < MINIMUM_HMDIST) == 0 <=> nearest >= target;
        * passers are verified with an exact k=1 Hamming query, and
          verified passers accumulate across chunks and rungs: the search
          stops at the first triage group (2-bit layout, chunked path) or
          rung (packed layout, monolithic path) where they reach ``n``;
        * the result is the ``n`` most distant verified candidates.
        """
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2 ** 63))
        device = self.index.device
        # reference base order G, C, A, T (core.py:590-592)
        cum = torch.cumsum(torch.tensor(
            [gc / 2, gc / 2, (1 - gc) / 2, (1 - gc) / 2],
            dtype=torch.float32), 0).to(device)
        chunk = _control_chunk_rows(device)

        acc: List[np.ndarray] = []        # verified passer codes so far
        acc_dist: List[np.ndarray] = []   # their exact nearest distances
        acc_n = 0
        searched = 0

        def sample(rung, c):
            return _sample_chunk(seed, rung, c, cum, chunk, length, device)

        def verify(pc):
            """Exact HAMMING k=1 distances; keep only >= target passers.
            The control rule is Hamming by definition (``MINIMUM_HMDIST``,
            the "Hamming distance" column), on either index metric."""
            nonlocal acc_n
            dists, _ = self.index.hamming_query_codes(pc, k=1)
            nearest = dists[:, 0].astype(np.int64)
            keep = nearest >= minimum_hmdist_target
            if keep.any():
                acc.append(pc[keep])
                acc_dist.append(nearest[keep])
                acc_n += int(keep.sum())

        def result(search_mult):
            pc_all = np.concatenate(acc)
            nearest = np.concatenate(acc_dist)
            order = np.argsort(-nearest, kind="stable")[:n]
            sort_dist = [float(nearest[i]) for i in order]
            sort_seq = dna.decode_rows(pc_all[order])
            return sort_seq, sort_dist, search_mult, searched

        def passer_codes(codes, passers):
            idx = torch.from_numpy(passers).to(device)
            return codes[idx].cpu().numpy()

        chunked = self.index.supports_chunk_triage(minimum_hmdist_target)
        search_mult = 0
        for rung, search_mult in enumerate(multiples):
            t_rung = time.time()
            m = n * search_mult
            nchunks = -(-m // chunk)
            if chunked:
                for c0 in range(0, nchunks, _TRIAGE_GROUP):
                    chunks = [sample(rung, c) for c in
                              range(c0, min(c0 + _TRIAGE_GROUP, nchunks))]
                    pm = self.index.pass_mask_chunks(chunks,
                                                     minimum_hmdist_target)
                    valid = min(len(chunks) * chunk, m - c0 * chunk)
                    passers = np.flatnonzero(pm[:valid])
                    searched += valid
                    if passers.size == 0:
                        continue
                    verify(passer_codes(torch.cat(chunks), passers))
                    if acc_n >= n:
                        logger.debug(
                            "control search: %d verified passers from %d "
                            "candidates (early exit inside rung %d, %.2fs)",
                            acc_n, searched, rung, time.time() - t_rung)
                        return result(search_mult)
            else:
                codes = torch.cat([sample(rung, c)
                                   for c in range(nchunks)])[:m]
                pm = self.index.pass_mask_within(codes, minimum_hmdist_target)
                searched += m
                if pm is None:      # uncountable target: exact k=1 for all
                    verify(codes.cpu().numpy())
                else:
                    passers = np.flatnonzero(pm)
                    if passers.size:
                        verify(passer_codes(codes, passers))
                if acc_n >= n:
                    logger.debug("control search: %d verified passers from "
                                 "%d candidates (rung %d, %.2fs)",
                                 acc_n, searched, rung, time.time() - t_rung)
                    return result(search_mult)
            logger.debug("control rung %d (m=%d): %d/%d verified passers "
                         "after %.2fs; escalating", rung, m, acc_n, n,
                         time.time() - t_rung)
        raise IndexError(
            "Could not find controls with minimum distance %d even with "
            "a search pool of %d" % (minimum_hmdist_target, n * search_mult))

    # ------------------------------------------------------------------
    def prewarm_controls(self, configpath: str, length: int, n: int) -> None:
        """A no-op, kept for the JAX package's API.  There it loads the
        control search's compiled programs ahead of use; here the kernels
        run eagerly and are built once per process, at their first launch,
        so there is nothing to warm.  Returns None."""
        return None

    # ------------------------------------------------------------------
    def launch_control_search(self, fastapath: str, configpath: str,
                              length: int = 20, n: int = 10,
                              num_threads: int = 2,
                              seed: Optional[int] = None):
        """Run the full control-guide search in a background thread.

        The search needs only the built index and one pass over the fasta
        for GC%, so launched right after the retention pass it overlaps the
        host-bound table stages.  A later ``get_control_seqs`` call with
        the same parameters joins the thread and returns its result;
        exceptions re-raise at the join.
        """
        from .io import parse_fasta

        self._control_args = (configpath, length, n, seed)
        self._control_result = None
        self._control_exc: Optional[BaseException] = None

        def _run():
            t0 = time.time()
            try:
                self._control_result = self._get_control_seqs_now(
                    parse_fasta(fastapath), configpath, length, n,
                    num_threads, seed)
                logger.debug("background control search finished in %.2fs",
                             time.time() - t0)
            except BaseException as exc:   # re-raised by get_control_seqs
                # logged now too: a caller that never joins still sees it
                logger.error("background control search failed: %r", exc)
                self._control_exc = exc

        t = threading.Thread(target=_run, name="gm-control-search",
                             daemon=True)
        t.start()
        self._control_thread = t
        return t

    def get_control_seqs(self, seq_record_iter, configpath: str,
                         length: int = 20, n: int = 10,
                         num_threads: int = 2, seed: Optional[int] = None):
        """Random non-targeting controls maximally distant from the genome.

        Replicates core.py:545-633: sample with genome GC composition,
        exact nearest-target distance via the index, keep the n most
        distant, escalate the candidate pool through
        ``CONTROL_SEARCH_MULTIPLE`` until ``n`` candidates reach
        ``MINIMUM_HMDIST``.  Raises IndexError when the ladder is exhausted
        (and, unlike the reference, *returns* on success at the final
        rung).  Returns ``(min distance, median distance, frame)`` with
        columns ``name``, ``Sequences``, ``Hamming distance``.

        ``seed`` makes the sampling reproducible on one device type (the
        reference is unseeded; ``None`` keeps that): CUDA and CPU draw
        other candidates, and neither draws the JAX package's.  If
        :meth:`launch_control_search` was started with the same
        parameters, this joins that thread instead of recomputing.
        """
        # ``num_threads`` is a reference-API no-op, so it is not part of
        # the join key
        th = getattr(self, "_control_thread", None)
        if (th is not None
                and getattr(self, "_control_args", None)
                == (configpath, length, n, seed)):
            th.join()
            self._control_thread = None
            if self._control_exc is not None:
                raise self._control_exc
            return self._control_result
        if th is not None and th.is_alive():
            logger.warning(
                "control search parameters changed (%r -> %r); recomputing "
                "while the stale background search still runs",
                getattr(self, "_control_args", None),
                (configpath, length, n, seed))
        return self._get_control_seqs_now(seq_record_iter, configpath,
                                          length, n, num_threads, seed)

    def _get_control_seqs_now(self, seq_record_iter, configpath: str,
                              length: int = 20, n: int = 10,
                              num_threads: int = 2,
                              seed: Optional[int] = None):
        with open(configpath) as cf:
            config = yaml.safe_load(cf)
        minimum_hmdist_target = config["CONTROL"]["MINIMUM_HMDIST"]
        multiples = config["CONTROL"]["CONTROL_SEARCH_MULTIPLE"]

        totlen = 0
        gccnt = 0.0
        for record in seq_record_iter:
            _, seq = record_id_and_seq(record)
            gccnt += dna.gc_fraction(seq) * len(seq)
            totlen += len(seq)
        gc = gccnt / totlen
        self.gc_percent = gc * 100
        self.genomesize = totlen / (1024 * 1024)
        sort_seq, sort_dist, search_mult, searched = self._control_search(
            gc, length, n, multiples, minimum_hmdist_target, seed)

        # candidates actually triaged (with cross-rung accumulation and
        # early exit, the honest figure is the number actually drawn)
        self.ncontrolsearched = searched
        randomdf = pd.DataFrame(
            data={"Sequences": sort_seq, "Hamming distance": sort_dist})
        randomdf["name"] = randomdf["Sequences"].apply(
            lambda s: "Cont-" + hashlib.md5(s.encode()).hexdigest())
        randomdf = randomdf[["name", "Sequences", "Hamming distance"]]
        return (min(sort_dist), statistics.median(sort_dist), randomdf)
