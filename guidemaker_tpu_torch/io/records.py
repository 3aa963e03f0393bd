"""Lightweight sequence/feature records shared by all parsers."""
from __future__ import annotations

import gzip
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


def is_gzip(filename: str) -> bool:
    """True if the file starts with the gzip magic bytes.

    Same check as the reference (``core.py:29-36``).
    """
    try:
        with open(filename, "rb") as f:
            return f.read(2) == b"\x1f\x8b"
    except IOError:
        logger.error("Could not open the file %s to determine if it was gzipped", filename)
        raise


def open_maybe_gzip(filename: str, mode: str = "rt"):
    """Open a plain or gzipped text file transparently."""
    if is_gzip(filename):
        return gzip.open(filename, mode)
    return open(filename, mode.replace("t", ""))


@dataclass
class Feature:
    """A genomic feature (e.g. a CDS) with 0-based half-open coordinates."""
    type: str
    start: int              # 0-based inclusive
    end: int                # 0-based exclusive
    strand: int             # +1 / -1 / 0 (unknown)
    qualifiers: Dict[str, List[str]] = field(default_factory=dict)

    def canonical_str(self) -> str:
        """Deterministic text form used to derive the feature id hash.

        The reference hashes Biopython's ``SeqFeature.__str__`` (core.py:721);
        we hash our own canonical form — ids are opaque and only used as
        join keys, so any deterministic unique string works.
        """
        quals = ";".join(
            f"{k}={','.join(v)}" for k, v in sorted(self.qualifiers.items())
        )
        return f"{self.type}:{self.start}-{self.end}({self.strand}):{quals}"


@dataclass
class SeqRecord:
    """A named sequence with optional annotation features."""
    id: str
    seq: str
    description: str = ""
    features: List[Feature] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.seq)

    def upper(self) -> "SeqRecord":
        return SeqRecord(self.id, self.seq.upper(), self.description, self.features)


def record_id_and_seq(record) -> tuple:
    """Accept our SeqRecord, a Biopython-like record, or an (id, seq) tuple."""
    if isinstance(record, SeqRecord):
        return record.id, record.seq
    if hasattr(record, "id") and hasattr(record, "seq"):
        return record.id, str(record.seq)
    rid, seq = record
    return rid, str(seq)
