"""Genome I/O: FASTA / GenBank / GFF / GTF readers and writers (gzip-aware).

Replaces the reference's Biopython ``SeqIO`` + ``pybedtools`` ingestion layer
(``guidemaker/core.py:1065-1090`` and ``core.py:691-772``)
with first-party parsers that feed numpy arrays directly.
"""
from .records import SeqRecord, Feature, is_gzip, open_maybe_gzip
from .fastaio import parse_fasta, write_fasta, get_fastas
from .genbankio import parse_genbank
from .gffio import parse_gff, sniff_gff_type

__all__ = [
    "SeqRecord", "Feature", "is_gzip", "open_maybe_gzip",
    "parse_fasta", "write_fasta", "get_fastas",
    "parse_genbank", "parse_gff", "sniff_gff_type",
]
