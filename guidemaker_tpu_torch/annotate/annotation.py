"""Annotation: feature ingestion, nearest-feature join, filters, output table.

Drop-in equivalent of the reference's ``Annotation`` class
(``guidemaker/core.py:636-984``) built on first-party
parsers (:mod:`guidemaker_tpu_torch.io`) and the owned interval engine
(:mod:`guidemaker_tpu_torch.annotate.closest`) instead of Biopython + pybedtools.

Feature ids are md5 hashes of a canonical feature string (opaque join keys;
the reference hashed Biopython's ``SeqFeature.__str__``, core.py:721 — ids
differ but are used consistently everywhere).

Known reference quirks replicated on purpose:

* ``_get_qualifiers``'s MINIMUM_PROPORTION filter is dead code upstream
  (``len(quals)/len(feature_dict[featkey])`` is always 1.0, core.py:801),
  so every qualifier key except the excluded ones is kept;
* ``_filter_features`` concatenates overlapping query results and may
  duplicate rows (core.py:886);
* the GFF path stores 1-based GFF coordinates directly as bed-style
  chromStart (core.py:741), and ``_format_guide_table`` adds +1 again;
* only the start columns get the 1-based offset in the final table
  (core.py:945-946).
"""
from __future__ import annotations

import hashlib
import logging
import re
from copy import deepcopy
from typing import Dict, List

import numpy as np
import pandas as pd
import yaml

from ..io import parse_genbank, parse_gff, sniff_gff_type
from ..io.gffio import parse_attributes
from .closest import _prep_features, closest_join_raw

logger = logging.getLogger(__name__)


class Annotation:
    """Targets + gene annotations: ingestion, join, filtering, formatting."""

    def __init__(self, annotation_list: List[str], annotation_type: str,
                 target_bed_df: pd.DataFrame) -> None:
        self.annotation_list = annotation_list
        self.annotation_type = annotation_type
        self.target_bed_df = target_bed_df
        self.genbank_bed_df: pd.DataFrame = None
        self.feature_dict: Dict = None
        self.nearby: pd.DataFrame = None
        self.filtered_df: pd.DataFrame = None
        self.qualifiers: pd.DataFrame = None
        self.pretty_df: pd.DataFrame = None

    # ------------------------------------------------------------------
    def check_annotation_type(self) -> str:
        """"gff" or "gtf" from the version pragma (core.py:665-689)."""
        return sniff_gff_type(self.annotation_list[0])

    # ------------------------------------------------------------------
    def get_annotation_features(self, feature_types: List[str] = None) -> None:
        """Parse features of the requested types into a bed frame + a
        qualifier dict-of-dicts (core.py:691-772)."""
        if feature_types is None:
            feature_types = ["CDS"]
        feature_dict: Dict[str, Dict[str, object]] = {}
        pddict = dict(chrom=[], chromStart=[], chromEnd=[], name=[], strand=[])

        if self.annotation_type == "genbank":
            for gbfile in self.annotation_list:
                for entry in parse_genbank(gbfile):
                    for record in entry.features:
                        if record.type not in feature_types:
                            continue
                        featid = hashlib.md5(
                            (entry.id + ":" + record.canonical_str()).encode()
                        ).hexdigest()
                        pddict["strand"].append("-" if record.strand == -1 else "+")
                        pddict["chrom"].append(entry.id)
                        pddict["chromStart"].append(int(record.start))
                        pddict["chromEnd"].append(int(record.end))
                        pddict["name"].append(featid)
                        for qkey, qval in record.qualifiers.items():
                            feature_dict.setdefault(qkey, {})[featid] = qval
        elif self.annotation_type == "gff":
            anno_format = self.check_annotation_type()
            for gff in self.annotation_list:
                for rec in parse_gff(gff):
                    if rec.type not in feature_types:
                        continue
                    featid = hashlib.md5(rec.raw().encode()).hexdigest()
                    # NOTE: 1-based GFF coords stored verbatim, like the
                    # reference (core.py:740-742)
                    pddict["chrom"].append(rec.seqid)
                    pddict["chromStart"].append(rec.start)
                    pddict["chromEnd"].append(rec.end)
                    pddict["strand"].append(rec.strand)
                    pddict["name"].append(featid)
                    for fkey, fval in parse_attributes(
                            rec.attributes, anno_format).items():
                        feature_dict.setdefault(fkey, {})[featid] = fval
        self.genbank_bed_df = pd.DataFrame.from_dict(pddict)
        self.feature_dict = feature_dict

    # ------------------------------------------------------------------
    def _get_qualifiers(self, configpath: str, excluded: List[str] = None) -> None:
        """Per-feature qualifier table (core.py:775-815)."""
        with open(configpath) as cf:
            config = yaml.safe_load(cf)
        min_prop = config["MINIMUM_PROPORTION"]
        if excluded is None:
            excluded = ["translation"]
        final_quals = []
        qual_df = pd.DataFrame(data={"Feature id": []})
        for featkey, quals in self.feature_dict.items():
            # reference quirk: ratio of a dict to itself -> always kept
            if len(quals) / len(self.feature_dict[featkey]) > min_prop:
                final_quals.append(featkey)
        for qualifier in final_quals:
            if qualifier in excluded:
                continue
            featlist, quallist = [], []
            for feat, qual in self.feature_dict[qualifier].items():
                featlist.append(feat)
                if isinstance(qual, list):
                    quallist.append(";".join(str(i) for i in qual))
                else:
                    quallist.append(qual)
            tempdf = pd.DataFrame({"Feature id": featlist, qualifier: quallist})
            qual_df = qual_df.merge(tempdf, how="outer", on="Feature id")
        self.qualifiers = qual_df

    # ------------------------------------------------------------------
    def _get_nearby_features(self) -> None:
        """Closest feature down- and upstream of every guide (core.py:817-848)."""
        # array-level sort + join: copying/sorting multi-million-row
        # frames with string columns costs more than the join itself
        featurebed = self.genbank_bed_df.copy()
        featurebed["chromStart"] = featurebed["chromStart"].astype(np.int64)
        featurebed["chromEnd"] = featurebed["chromEnd"].astype(np.int64)
        featurebed = featurebed.sort_values(
            by=["chrom", "chromStart", "chromEnd"], kind="stable")

        mb = self.target_bed_df
        g_chrom = mb["chrom"].to_numpy()
        g_start = mb["chromstart"].to_numpy(dtype=np.int64)
        g_end = mb["chromend"].to_numpy(dtype=np.int64)
        g_name = mb["name"].to_numpy()
        g_strand = mb["strand"].to_numpy()
        # factorize instead of np.unique: hash-based, no O(n log n) sort
        # of millions of strings; the bed arrives chrom-sorted
        # (export_bed), so appearance order == sorted order and the
        # lexsort keys are unchanged
        chrom_cat = pd.factorize(pd.Series(g_chrom), sort=True)
        chrom_codes = chrom_cat[0]
        order = np.lexsort((g_end, g_start, chrom_codes))
        g_chrom, g_start, g_end, g_name, g_strand, chrom_codes = (
            g_chrom[order], g_start[order], g_end[order], g_name[order],
            g_strand[order], chrom_codes[order])
        chrom_groups = {str(c): np.nonzero(chrom_codes == i)[0]
                        for i, c in enumerate(chrom_cat[1])}

        feats = _prep_features(featurebed)
        downstream = closest_join_raw(g_chrom, g_start, g_end, g_name,
                                      g_strand, feats, "downstream",
                                      chrom_groups=chrom_groups)
        upstream = closest_join_raw(g_chrom, g_start, g_end, g_name,
                                    g_strand, feats, "upstream",
                                    chrom_groups=chrom_groups)
        headers = ["Accession", "Guide start", "Guide end",
                   "Guide sequence", "Guide strand",
                   "Feature Accession", "Feature start",
                   "Feature end", "Feature id", "Feature strand",
                   "Feature distance"]
        n = len(downstream[0])
        # one frame for both passes; low-cardinality columns categorical
        # (pandas 3 converts str columns to Arrow arrays — doing that for
        # millions of repeated accession/strand/feature-id values per pass
        # dominated this stage)
        cols = {}
        for i, name in enumerate(headers):
            both = np.concatenate([downstream[i], upstream[i]])
            if i in (4, 9):   # strand columns must share categories so
                # the filters compare across frames; GFF also allows '?'
                # (or arbitrary text) — union observed values in so
                # nothing is silently coerced to NaN (pd.unique: hash-
                # based, np.unique would sort millions of strings)
                strand_cats = ["+", "-", "."] + sorted(
                    set(pd.unique(both)) - {"+", "-", "."})
                cols[name] = pd.Categorical(both, categories=strand_cats)
            elif i in (0, 5, 8):
                cols[name] = pd.Categorical(both)
            else:
                cols[name] = both
        cols["direction"] = pd.Categorical.from_codes(
            np.repeat([0, 1], n), categories=["downstream", "upstream"])
        index = np.tile(np.arange(n), 2)  # concat-of-two-passes index
        self.nearby = pd.DataFrame(cols, index=index)

    # ------------------------------------------------------------------
    def _filter_features(self, before_feat: int = 100,
                         after_feat: int = 200) -> None:
        """Keep guides close enough to a feature to interact (core.py:851-886).

        Seven clauses over (guide strand x feature strand x distance), with
        the reference's row order and potential duplicates preserved.
        """
        nb = self.nearby
        gplus = nb["Guide strand"] == "+"
        gminus = nb["Guide strand"] == "-"
        fplus = nb["Feature strand"] == "+"
        fminus = nb["Feature strand"] == "-"
        dist = nb["Feature distance"]
        zero = dist == 0

        # row positions per clause, concatenated in the reference's
        # concat order (duplicates preserved), then ONE take — boolean
        # indexing a multi-million-row frame with string columns seven
        # times dominated this stage
        masks = [
            (nb["Guide strand"] == nb["Feature strand"])
            & (0 < dist) & (dist < before_feat),
            gplus & fplus & zero
            & (nb["Guide end"] - nb["Feature start"] < after_feat),
            gminus & fminus & zero
            & (nb["Feature end"] - nb["Guide start"] < after_feat),
            gminus & fplus
            & (0 < nb["Feature start"] - nb["Guide end"])
            & (nb["Feature start"] - nb["Guide end"] < before_feat),
            gplus & fminus
            & (0 < nb["Guide start"] - nb["Feature end"])
            & (nb["Guide start"] - nb["Feature end"] < before_feat),
            gminus & fplus
            & (0 < nb["Guide end"] - nb["Feature start"])
            & (nb["Guide end"] - nb["Feature start"] < after_feat),
            gplus & fminus
            & (0 < nb["Feature end"] - nb["Guide start"])
            & (nb["Feature end"] - nb["Guide start"] < after_feat),
        ]
        pos = np.concatenate(
            [np.flatnonzero(m.to_numpy()) for m in masks])
        self.filtered_df = nb.take(pos)

    # ------------------------------------------------------------------
    def _format_guide_table(self, targetprocessor_object) -> None:
        """Final "pretty" guide table (core.py:888-948)."""
        def get_guide_hash(seq):
            return hashlib.md5(seq.encode()).hexdigest()

        from ..util import substage_timer
        pretty_df = deepcopy(self.filtered_df)
        with substage_timer("format: passing filter"):
            # set-membership on host objects: Arrow isin hashes the whole
            # million-entry passing set into an Arrow array first (~12 s)
            pass_set = set(targetprocessor_object.passing_seqs())
            seq_col = pretty_df["Guide sequence"].to_numpy()
            keep = np.fromiter((s in pass_set for s in seq_col), dtype=bool,
                               count=len(seq_col))
            pretty_df = pretty_df[keep]
        with substage_timer("format: gc+hash"):
            seq_list = pretty_df["Guide sequence"].tolist()
            if seq_list:
                from .. import dna
                gcodes = dna.encode_batch(seq_list, len(seq_list[0]))
                pretty_df["GC"] = ((gcodes == dna.G) | (gcodes == dna.C)) \
                    .mean(axis=1)
            else:
                pretty_df["GC"] = np.empty(0)
            pretty_df["Guide name"] = [get_guide_hash(s) for s in seq_list]
            pretty_df["Target strand"] = np.where(
                pretty_df["Guide strand"] == pretty_df["Feature strand"],
                "coding", "non-coding")
        with substage_timer("format: neighbor frame"):
            # similar-guide strings, built vectorized only for retained
            need = pretty_df["Guide sequence"].unique()
            simframe = targetprocessor_object.neighbor_frame(need)
        with substage_timer("format: sim merge"):
            pretty_df = pd.merge(pretty_df, simframe, how="left",
                                 on="Guide sequence")

        targets = targetprocessor_object.targets
        with substage_timer("format: targets merge"):
            # positional mapping instead of the reference's 4-key string
            # merge: a PAM target is uniquely identified by
            # (accession, start, strand) — the sequence/stop keys of the
            # reference merge are redundant — so the "merge" is one int64
            # get_indexer + three column takes.  Equivalent to the old
            # how="left" merge (targets rows are unique on the key; missing
            # keys, impossible for rows that came from export_bed, would map
            # to NaN exactly as a left join does).
            t_keep = targets["target"].isin(need).to_numpy()
            targets = targets[t_keep]
            acc_cats = pd.Index(pd.unique(targets["seqid"].astype(str)))
            t_acc = acc_cats.get_indexer(targets["seqid"].astype(str))
            t_strand = targets["strand"].to_numpy().astype(np.int64)
            t_key = ((t_acc.astype(np.int64) << 34)
                     | (targets["start"].to_numpy(np.int64) << 1) | t_strand)
            p_acc_map = acc_cats.get_indexer(
                pretty_df["Accession"].cat.categories)
            p_acc = p_acc_map[pretty_df["Accession"].cat.codes.to_numpy()]
            p_strand = (pretty_df["Guide strand"].to_numpy() == "+") \
                .astype(np.int64)
            p_key = ((p_acc.astype(np.int64) << 34)
                     | (pretty_df["Guide start"].to_numpy(np.int64) << 1)
                     | p_strand)
            pos = pd.Index(t_key).get_indexer(p_key)
            hit = pos >= 0
            safe_pos = np.where(hit, pos, 0)
            for src, dst in (("dtype", "dtype"), ("exact_pam", "PAM"),
                             ("target_seq30", "target_seq30")):
                # positional take on the Arrow-backed column (C++; no Python
                # strings), re-axised onto pretty_df's index
                vals = targets[src].iloc[safe_pos].set_axis(pretty_df.index)
                if not hit.all():                 # left-join NaN semantics
                    vals[~hit] = None
                pretty_df[dst] = vals
            pretty_df = pretty_df[[
                "Guide name", "Guide sequence", "GC", "dtype", "Accession",
                "Guide start", "Guide end", "Guide strand", "PAM", "Feature id",
                "Feature start", "Feature end", "Feature strand",
                "Feature distance", "Similar guides", "Similar guide distances",
                "target_seq30"]]
        with substage_timer("format: quals merge+sort"):
            # qualifier columns via category-level mapping: Feature id is
            # Categorical with ~#features levels, so one get_indexer over
            # the LEVELS + a code take replaces a 100k-row string merge.
            # Column order and left-join NaN semantics are preserved.
            fid = pretty_df["Feature id"]
            if (isinstance(fid.dtype, pd.CategoricalDtype)
                    and len(self.qualifiers)):
                qidx = pd.Index(self.qualifiers["Feature id"])
                lvl = qidx.get_indexer(fid.cat.categories)
                codes = fid.cat.codes.to_numpy()
                row = np.where(codes >= 0, lvl[codes], -1)
                qhit = row >= 0
                safe = np.where(qhit, row, 0)
                for col in self.qualifiers.columns:
                    if col == "Feature id":
                        continue
                    src = self.qualifiers[col].to_numpy()
                    vals = pd.Series(src[safe], index=pretty_df.index,
                                     dtype=self.qualifiers[col].dtype)
                    if not qhit.all():
                        vals[~qhit] = None
                    pretty_df[col] = vals
            else:
                pretty_df = pretty_df.merge(self.qualifiers, how="left",
                                            on="Feature id")
            pretty_df = pretty_df.sort_values(by=["Accession", "Feature start"])
            # 1-based offset applied to start columns only (reference behavior)
            pretty_df["Guide start"] = pretty_df["Guide start"] + 1
            pretty_df["Feature start"] = pretty_df["Feature start"] + 1
            pretty_df = pretty_df.loc[
                pretty_df["target_seq30"].str.len() == 30]
        self.pretty_df = pretty_df

    # ------------------------------------------------------------------
    def _filterlocus(self, attribute: str = "locus_tag",
                     filter_by_locus: list = None) -> pd.DataFrame:
        """Optional subset by attribute values (core.py:950-965)."""
        if filter_by_locus is None:
            filter_by_locus = []
        df = deepcopy(self.pretty_df)
        if len(filter_by_locus) > 0:
            df = df[df[attribute].isin(filter_by_locus)]
        return df

    # ------------------------------------------------------------------
    def locuslen(self):
        """(first qualifier key, its feature count) (core.py:967-984)."""
        da_keys = list(self.feature_dict.keys())
        firsttag = da_keys[0] if da_keys else None
        if firsttag:
            return firsttag, len(self.feature_dict[firsttag].keys())
        logger.warning("A locus key could not be found.")
        return "notag", 0
