"""PAM/target enumeration: vectorized degenerate-motif scan over the genome.

Vectorized replacement for the reference's ``PamTarget`` class
(``guidemaker/core.py:39-292``).  Instead of an overlapped
``regex.finditer`` scan (a C-extension byte loop), the genome is encoded as a
uint8 code array and a degenerate PAM is matched with an AND-reduction of
per-position IUPAC bit masks over shifted views — O(|genome| * |PAM|)
vectorized ops, overlap-native, both strands.

Output is a pandas DataFrame with the exact schema, row order, coordinate
conventions and edge-case semantics of the reference:

* coordinates are 0-based, target-only (PAM excluded), ``start < stop`` in
  forward-text coordinates even for reverse-strand hits (core.py:142-246);
* ``strand``: True=forward; ``pam_orientation``: True=5prime (core.py:162-165);
* targets containing non-ACGT or truncated by a contig edge are dropped
  (``check_target``, core.py:127-140);
* the 30-mer Doench context window replicates *Python slice semantics*
  including the negative-index quirk at contig edges (core.py:156,184,210,237)
  — malformed windows are kept here and dropped later by the table formatter,
  exactly like the reference.
"""
from __future__ import annotations

import logging
from typing import Iterable, List, Tuple

import numpy as np
import pandas as pd

from . import dna
from .io.records import record_id_and_seq

logger = logging.getLogger(__name__)

IUPAC_LETTERS = set("ACGTMRWSYKVHDBXN")


def scan_motif(codes: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Return all (overlapping) start positions where the motif matches.

    ``codes``: uint8 genome codes; ``masks``: per-position IUPAC bit masks.
    """
    n, p = codes.shape[0], masks.shape[0]
    if n < p:
        return np.empty(0, dtype=np.int64)
    bits = dna.CODE_TO_BIT[codes]
    match = (bits[: n - p + 1] & masks[0]) != 0
    for j in range(1, p):
        match &= (bits[j: n - p + 1 + j] & masks[j]) != 0
    return np.nonzero(match)[0]


def _valid_windows(inv_prefix: np.ndarray, a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Windows [a, b) fully inside [0, n) with no invalid (non-ACGT) codes."""
    ok = (a >= 0) & (b <= n) & (b > a)
    res = np.zeros(a.shape[0], dtype=bool)
    if ok.any():
        aa, bb = a[ok], b[ok]
        res[ok] = (inv_prefix[bb] - inv_prefix[aa]) == 0
    return res


def _extract_rows(codes: np.ndarray, starts: np.ndarray, length: int) -> np.ndarray:
    """Gather (len(starts), length) windows from a 1-D code array.

    A row gather from a sliding-window *view* is one contiguous-block copy
    per row (~250x faster than the equivalent 2-D fancy index)."""
    if starts.size == 0:
        return np.empty((0, length), dtype=np.uint8)
    return np.lib.stride_tricks.sliding_window_view(codes, length)[starts]


class PamTarget:
    """A PAM motif plus methods to enumerate all matching targets.

    Drop-in equivalent of the reference class (core.py:39-292): same
    constructor validation, same ``find_targets`` DataFrame contract.
    """

    def __init__(self, pam: str, pam_orientation: str, dtype: str = "hamming") -> None:
        for letter in pam.upper():
            assert letter in IUPAC_LETTERS
        assert pam_orientation in ["3prime", "5prime"]
        self.pam: str = pam.upper()
        self.pam_orientation: str = pam_orientation
        self.dtype: str = dtype

    def __str__(self) -> str:
        return "A PAM object: {self.pam}".format(self=self)

    # ------------------------------------------------------------------
    def find_targets(self, seq_record_iter: Iterable, target_len: int) -> pd.DataFrame:
        """Find all targets matching the PAM on both strands of all contigs.

        All string columns are materialized in ONE bulk Arrow build at the
        end (``dna.rows_to_str_array``) — the per-row decode + pandas
        ``str``-dtype conversion used to dominate the scan stage wall time
        (~6 s for the 1.17M-guide P. aeruginosa pool; this path is ~0.4 s).
        """
        chunks: List[dict] = []
        fwd_masks = dna.pam_bit_masks(self.pam)
        rev_masks = dna.pam_bit_masks(dna.reverse_complement(self.pam))
        p = len(self.pam)
        is5 = self.pam_orientation == "5prime"
        rids: List[str] = []

        for record in seq_record_iter:
            rid, seq = record_id_and_seq(record)
            rids.append(rid)
            codes = dna.STRICT_BYTE_TO_CODE[
                np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
            n = codes.shape[0]
            inv_prefix = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(codes >= 4, out=inv_prefix[1:])

            fwd_hits = scan_motif(codes, fwd_masks)
            rev_hits = scan_motif(codes, rev_masks)

            for strand_fwd, hits in ((True, fwd_hits), (False, rev_hits)):
                chunk = self._hits_to_arrays(
                    seq, codes, inv_prefix, n, hits, p, target_len,
                    strand_fwd=strand_fwd, is5=is5)
                if chunk is not None:
                    chunk["rid"] = len(rids) - 1
                    chunks.append(chunk)

        if not chunks:
            # zero PAM hits anywhere (the reference builds per-strand
            # frames unconditionally and survives): return an empty frame
            # with the full schema instead of crashing in pd.concat
            df_targets = pd.DataFrame({
                "target": pd.Series(dtype="str"),
                "exact_pam": pd.Series(dtype="str"),
                "start": pd.Series(dtype="uint32"),
                "stop": pd.Series(dtype="uint32"),
                "strand": pd.Series(dtype="bool"),
                "pam_orientation": pd.Series(dtype="bool"),
                "target_seq30": pd.Series(dtype="str"),
                "seqid": pd.Series(dtype="str"),
            }).astype({"exact_pam": "category", "seqid": "category"})
        else:
            sizes = [c["start"].size for c in chunks]
            total = int(np.sum(sizes))
            bases = np.concatenate([[0], np.cumsum(sizes)])[:-1]
            tmat = np.concatenate([c["tmat"] for c in chunks])
            pmat = np.concatenate([c["pmat"] for c in chunks])
            ctx_bytes = np.concatenate([c["ctx_bytes"] for c in chunks])
            ctx_exc = {int(base) + i: s
                       for base, c in zip(bases, chunks)
                       for i, s in c["ctx_exc"].items()}
            # exact_pam as a categorical built from packed integer keys:
            # big-endian base-4 packing preserves lexicographic order
            # (A<C<G<T == 0<1<2<3), so np.unique's sorted uniques match
            # pandas astype("category") category order
            weights = (4 ** np.arange(p - 1, -1, -1)).astype(np.int64)
            packed = pmat.astype(np.int64) @ weights
            uniq, inverse = np.unique(packed, return_inverse=True)
            upam_codes = ((uniq[:, None] // weights[None, :]) % 4)
            pam_cats = dna.decode_rows(upam_codes.astype(np.uint8))
            exact_pam = pd.Categorical.from_codes(inverse, pam_cats)
            seq_codes = np.repeat(
                np.fromiter((c["rid"] for c in chunks), np.int64,
                            count=len(chunks)),
                sizes)
            # categories: only contigs that produced hits, sorted (matches
            # astype("category") on the concatenated string column).
            # Duplicate record ids across contigs (legal FASTA, merged
            # silently by astype("category")) map to ONE category index —
            # Categorical.from_codes requires unique categories.
            present = np.unique(seq_codes)
            cats = sorted({rids[i] for i in present})
            cat_pos = {s: j for j, s in enumerate(cats)}
            rank = np.full(len(rids), -1, dtype=np.int64)
            for i in present:
                rank[i] = cat_pos[rids[i]]
            seqid = pd.Categorical.from_codes(rank[seq_codes], cats)
            df_targets = pd.DataFrame({
                "target": dna.rows_to_str_array(tmat),
                "exact_pam": exact_pam,
                "start": np.concatenate(
                    [c["start"] for c in chunks]).astype(np.uint32),
                "stop": np.concatenate(
                    [c["stop"] for c in chunks]).astype(np.uint32),
                "strand": np.repeat(
                    np.fromiter((c["strand_fwd"] for c in chunks), bool,
                                count=len(chunks)), sizes),
                "pam_orientation": np.full(total, is5, dtype=bool),
                "target_seq30": dna.bytes_rows_to_str_array(
                    ctx_bytes, ctx_exc),
                "seqid": seqid,
            })
        df_targets = df_targets.assign(
            seedseq=None, hasrestrictionsite=None, isseedduplicated=None)
        df_targets = df_targets.assign(dtype=self.dtype)
        df_targets = df_targets.astype({"dtype": "category"})
        return df_targets

    # ------------------------------------------------------------------
    def _hits_to_arrays(self, seq, codes, inv_prefix, n, hits, p, target_len,
                        *, strand_fwd: bool, is5: bool):
        """Convert motif hit positions into target row *arrays* for one strand.

        Replicates the four reference generators run_for_5p / run_for_3p /
        run_rev_5p / run_rev_3p (core.py:142-246).  On the reverse strand the
        *reverse-complemented PAM* was matched on forward text, so the hit
        geometry mirrors: a rev-strand "5prime" hit takes the target upstream
        of the motif (and reverse-complements it).

        Returns None when no hits survive, else a dict of numpy arrays
        (code matrices stay undecoded; ``find_targets`` builds all string
        columns in one bulk Arrow pass).
        """
        L = target_len
        s, e = hits, hits + p
        # Geometry table (forward-text coordinates of the target window):
        #   fwd 5p: [e, e+L)   ctx30 = [s-3, s+27)
        #   fwd 3p: [s-L, s)   ctx30 = [e-27, e+3)
        #   rev 5p: [s-L, s)   ctx30 = revcomp([e-27, e+3))
        #   rev 3p: [e, e+L)   ctx30 = revcomp([s-3, s+27))
        downstream = (is5 and strand_fwd) or (not is5 and not strand_fwd)
        if downstream:
            a, b = e, e + L
        else:
            a, b = s - L, s
        valid = _valid_windows(inv_prefix, a, b, n)
        s, e, a, b = s[valid], e[valid], a[valid], b[valid]
        if s.size == 0:
            return None

        tmat = _extract_rows(codes, a, L)
        pmat = _extract_rows(codes, s, p)
        if not strand_fwd:
            tmat = dna.revcomp_codes(tmat)
            pmat = dna.revcomp_codes(pmat)

        # 30-mer context with Python slice semantics (edge rows may be short
        # or wrapped; kept as-is, dropped later — reference behavior).
        if is5:
            c_lo, c_hi = (s - 3, s + 27) if strand_fwd else (e - 27, e + 3)
        else:
            c_lo, c_hi = (e - 27, e + 3) if strand_fwd else (s - 3, s + 27)
        ctx_ok = (c_lo >= 0) & (c_hi <= n)
        ctx_bytes = np.zeros((s.size, 30), dtype=np.uint8)
        ctx_exc: dict = {}
        if ctx_ok.any():
            cmat = _extract_rows(codes, c_lo[ctx_ok].astype(np.int64), 30)
            if not strand_fwd:
                cmat = dna.revcomp_codes(cmat)
            # decode through the permissive table: context may contain
            # non-ACGT letters which the reference keeps verbatim; we map
            # them to N in the byte matrix, and recover exact text from the
            # raw string where the window contains invalid codes.
            ctx_bytes[ctx_ok] = dna.CODE_TO_BYTE[cmat]
            # windows containing non-ACGT letters: take exact text
            has_inv = np.zeros(s.size, dtype=bool)
            lo = c_lo.copy()
            lo[lo < 0] = 0
            has_inv[ctx_ok] = (inv_prefix[np.minimum(c_hi[ctx_ok], n)]
                               - inv_prefix[lo[ctx_ok]]) > 0
            for i in np.nonzero(ctx_ok & has_inv)[0]:
                raw = seq[int(c_lo[i]):int(c_hi[i])]
                ctx_exc[int(i)] = (dna.reverse_complement(raw)
                                   if not strand_fwd else raw)
        for i in np.nonzero(~ctx_ok)[0]:
            # Python slice semantics incl. the negative-index quirk at
            # contig edges (reference core.py:156,184,210,237)
            raw = seq[int(c_lo[i]):int(c_hi[i])]
            if not strand_fwd:
                raw = dna.reverse_complement(raw)
            ctx_exc[int(i)] = raw

        return {"tmat": tmat, "pmat": pmat, "ctx_bytes": ctx_bytes,
                "ctx_exc": ctx_exc, "start": a, "stop": b,
                "strand_fwd": strand_fwd}
