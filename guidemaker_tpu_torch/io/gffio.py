"""GFF3 / GTF parsing (first-party replacement for the reference's
``pybedtools.BedTool`` iteration at ``core.py:734-769``)."""
from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List

from .records import open_maybe_gzip

logger = logging.getLogger(__name__)


@dataclass
class GffRecord:
    """One GFF/GTF line (coordinates kept 1-based as in the file)."""
    seqid: str
    source: str
    type: str
    start: int            # 1-based inclusive (as in file)
    end: int              # 1-based inclusive (as in file)
    score: str
    strand: str
    frame: str
    attributes: str       # raw column 9

    def raw(self) -> str:
        return "\t".join([self.seqid, self.source, self.type, str(self.start),
                          str(self.end), self.score, self.strand, self.frame,
                          self.attributes])


def sniff_gff_type(path: str) -> str:
    """Return "gff" or "gtf" based on the version pragma on line 1.

    Mirrors the reference's strict check (``core.py:665-689``): raises
    ValueError when neither ``gff-version`` nor ``gtf-version`` is found.
    """
    with open_maybe_gzip(path, "rt") as f:
        line1 = f.readline()
    if re.search("gff-version", line1):
        return "gff"
    if re.search("gtf-version", line1):
        return "gtf"
    logger.error(
        "Could not verify the GFF/GTF file type. Please make sure your "
        "GFF/GTF file starts with '#gtf-version' or '##gff-version'")
    raise ValueError


def parse_gff(path: str) -> Iterator[GffRecord]:
    """Yield records from a GFF/GTF file (optionally gzipped)."""
    with open_maybe_gzip(path, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            cols = line.split("\t")
            if len(cols) < 9:
                continue
            try:
                yield GffRecord(cols[0], cols[1], cols[2], int(cols[3]),
                                int(cols[4]), cols[5], cols[6], cols[7], cols[8])
            except ValueError:
                logger.warning("Skipping malformed GFF/GTF line: %r", line)


def parse_attributes(attributes: str, anno_format: str) -> Dict[str, str]:
    """Parse column 9 into key->value, replicating the reference's logic
    (``core.py:746-769``): GFF uses ``k=v``; GTF uses ``k "v"``.

    Malformed attributes are skipped with a warning, like the reference.
    """
    out: Dict[str, str] = {}
    for feat in attributes.split(";"):
        if not feat or feat.isspace():
            continue
        try:
            if anno_format == "gtf":
                key = re.search('^[^"]*', feat).group(0).strip()
                val = re.search('"([^"]*)"', feat).group(0).strip('"')
            else:
                parts = feat.split("=")
                key, val = parts[0], parts[1]
            out[key] = val
        except Exception:
            logger.warning(
                "There appears to be an error in the formatting of an attribute "
                "in the record. The attribute is: %s. Skipping this feature.", feat)
            continue
    return out
