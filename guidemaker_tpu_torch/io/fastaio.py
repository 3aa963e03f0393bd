"""FASTA reading/writing (gzip-aware) and GenBank/FASTA -> FASTA conversion."""
from __future__ import annotations

import logging
import os
from typing import Iterator, List, Sequence

from .records import SeqRecord, open_maybe_gzip

logger = logging.getLogger(__name__)


def parse_fasta(path_or_handle) -> Iterator[SeqRecord]:
    """Stream SeqRecords from a FASTA file path (optionally gzipped) or handle."""
    if isinstance(path_or_handle, (str, os.PathLike)):
        handle = open_maybe_gzip(str(path_or_handle), "rt")
        close = True
    else:
        handle = path_or_handle
        close = False
    try:
        rid = None
        desc = ""
        chunks: List[str] = []
        for line in handle:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if rid is not None:
                    yield SeqRecord(rid, "".join(chunks), desc)
                header = line[1:].strip()
                rid = header.split(None, 1)[0] if header else ""
                desc = header
                chunks = []
            elif line:
                chunks.append(line.strip())
        if rid is not None:
            yield SeqRecord(rid, "".join(chunks), desc)
    finally:
        if close:
            handle.close()


def write_fasta(records: Sequence[SeqRecord], handle, width: int = 60) -> None:
    """Write records in FASTA format with fixed line wrapping."""
    for rec in records:
        header = rec.description if rec.description else rec.id
        handle.write(f">{header}\n")
        seq = rec.seq
        for i in range(0, len(seq), width):
            handle.write(seq[i:i + width] + "\n")


def get_fastas(filelist, input_format: str = "genbank", tempdir: str = None) -> str:
    """Concatenate 1+ GenBank or FASTA files into ``tempdir/forward.fasta``.

    Records are upper-cased (removes soft-masking, matching the reference's
    behavior at ``core.py:1065-1090``).  Returns the output path.
    """
    from .genbankio import parse_genbank

    if isinstance(filelist, (str, os.PathLike)):
        filelist = [filelist]
    fastapath = os.path.join(tempdir, "forward.fasta")
    try:
        with open(fastapath, "w") as out:
            for file in filelist:
                if input_format == "genbank":
                    records = parse_genbank(file)
                else:
                    records = parse_fasta(file)
                write_fasta([r.upper() for r in records], out)
    except Exception:
        logger.exception("An error occurred in the input file %s", file)
        raise
    return fastapath
