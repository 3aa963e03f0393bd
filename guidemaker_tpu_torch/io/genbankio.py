"""Minimal-but-correct GenBank flat-file parser.

First-party replacement for Biopython ``SeqIO.parse(handle, "genbank")`` as
used by the reference (``core.py:706-733`` for features, ``core.py:1065-1090``
for sequence extraction).  Parses LOCUS records with FEATURES (key, location,
qualifiers) and ORIGIN sequence. Supports ``complement(...)``, ``join(...)``
and partial (``<``/``>``) locations; multi-record files; gzip.
"""
from __future__ import annotations

import logging
import os
import re
from typing import Iterator, List

from .records import Feature, SeqRecord, open_maybe_gzip

logger = logging.getLogger(__name__)

_NUM = re.compile(r"[<>]?(\d+)")


def _parse_location(loc: str):
    """Location string -> (start0, end0, strand).

    start is 0-based inclusive, end 0-based exclusive (Biopython convention:
    ``location.start = min-1``, ``location.end = max``).

    ``join(...)`` locations reduce to their (min, max) envelope — exactly
    what the reference consumes (Biopython's ``.start``/``.end`` across a
    CompoundLocation are the envelope bounds, core.py:735-739).  KNOWN
    LIMIT shared with the reference: a join that wraps the origin of a
    circular genome (e.g. ``join(9000..9500,1..200)``) envelopes to
    nearly the whole sequence; neither implementation splits it.
    """
    strand = -1 if "complement" in loc else 1
    nums = [int(m) for m in _NUM.findall(loc)]
    if not nums:
        raise ValueError(f"Unparseable GenBank location: {loc!r}")
    return min(nums) - 1, max(nums), strand


def parse_genbank(path_or_handle) -> Iterator[SeqRecord]:
    """Yield SeqRecords (with features) from a GenBank file (optionally gzipped)."""
    if isinstance(path_or_handle, (str, os.PathLike)):
        handle = open_maybe_gzip(str(path_or_handle), "rt")
        close = True
    else:
        handle = path_or_handle
        close = False
    try:
        yield from _parse(handle)
    finally:
        if close:
            handle.close()


def _parse(handle) -> Iterator[SeqRecord]:
    locus_name = None
    accession = None
    version = None
    definition_parts: List[str] = []
    features: List[Feature] = []
    seq_chunks: List[str] = []
    state = "header"          # header | features | origin
    cur_feature = None        # Feature being assembled
    cur_loc_parts: List[str] = []
    cur_qual_key = None
    cur_qual_parts: List[str] = []
    pending_location = False

    def flush_qualifier():
        nonlocal cur_qual_key, cur_qual_parts
        if cur_feature is None or cur_qual_key is None:
            cur_qual_key, cur_qual_parts = None, []
            return
        joiner = "" if cur_qual_key == "translation" else " "
        val = joiner.join(cur_qual_parts)
        if val.startswith('"') and val.endswith('"') and len(val) >= 2:
            val = val[1:-1]
        cur_feature.qualifiers.setdefault(cur_qual_key, []).append(val)
        cur_qual_key, cur_qual_parts = None, []

    def flush_feature():
        nonlocal cur_feature, cur_loc_parts, pending_location
        flush_qualifier()
        if cur_feature is not None:
            loc = "".join(cur_loc_parts)
            try:
                start, end, strand = _parse_location(loc)
                cur_feature.start, cur_feature.end, cur_feature.strand = start, end, strand
                features.append(cur_feature)
            except ValueError:
                logger.warning("Skipping feature with unparseable location %r", loc)
        cur_feature, cur_loc_parts, pending_location = None, [], False

    def make_record():
        rid = version or accession or locus_name or ""
        definition = " ".join(definition_parts).strip()
        if definition.endswith("."):
            definition = definition[:-1]
        desc = f"{rid} {definition}".strip()
        return SeqRecord(rid, "".join(seq_chunks), desc, list(features))

    for raw in handle:
        line = raw.rstrip("\n").rstrip("\r")
        if state == "header":
            if line.startswith("LOCUS"):
                parts = line.split()
                locus_name = parts[1] if len(parts) > 1 else None
            elif line.startswith("DEFINITION"):
                definition_parts = [line[12:].strip()]
                state = "definition"
            elif line.startswith("ACCESSION"):
                parts = line.split()
                accession = parts[1] if len(parts) > 1 else None
            elif line.startswith("VERSION"):
                parts = line.split()
                version = parts[1] if len(parts) > 1 else None
            elif line.startswith("FEATURES"):
                state = "features"
            elif line.startswith("ORIGIN"):
                state = "origin"
        elif state == "definition":
            if line.startswith(" "):
                definition_parts.append(line.strip())
            else:
                state = "header"
                # re-dispatch this non-continuation line through header logic
                if line.startswith("ACCESSION"):
                    parts = line.split()
                    accession = parts[1] if len(parts) > 1 else None
                elif line.startswith("VERSION"):
                    parts = line.split()
                    version = parts[1] if len(parts) > 1 else None
                elif line.startswith("FEATURES"):
                    state = "features"
                elif line.startswith("ORIGIN"):
                    state = "origin"
        elif state == "features":
            if line.startswith("ORIGIN"):
                flush_feature()
                state = "origin"
            elif line.startswith("CONTIG") or line.startswith("BASE COUNT"):
                flush_feature()
            elif line[:1] not in (" ", ""):
                # unexpected top-level keyword inside FEATURES
                flush_feature()
                state = "header"
            elif len(line) > 5 and line[5] not in (" ",) and line[:5] == "     ":
                # new feature: key starts at column 5
                flush_feature()
                key = line[5:21].strip()
                loc = line[21:].strip()
                cur_feature = Feature(type=key, start=0, end=0, strand=1)
                cur_loc_parts = [loc]
                pending_location = True
            else:
                content = line[21:].strip() if len(line) > 21 else ""
                if content.startswith("/") and "=" in content:
                    flush_qualifier()
                    pending_location = False
                    key, _, val = content[1:].partition("=")
                    cur_qual_key = key
                    cur_qual_parts = [val]
                elif content.startswith("/") and re.fullmatch(r"/[\w\-']+", content):
                    # flag qualifier like /pseudo
                    flush_qualifier()
                    pending_location = False
                    if cur_feature is not None:
                        cur_feature.qualifiers.setdefault(content[1:], []).append("")
                elif pending_location and content:
                    cur_loc_parts.append(content)
                elif content:
                    cur_qual_parts.append(content)
        elif state == "origin":
            if line.startswith("//"):
                yield make_record()
                locus_name = accession = version = None
                definition_parts = []
                features = []
                seq_chunks = []
                state = "header"
            else:
                seq_chunks.append("".join(line.split()[1:]) if line[:1] == " " or line[:1].isdigit() else "".join(line.split()))
    # file without trailing // (tolerate)
    if seq_chunks or features:
        yield make_record()
