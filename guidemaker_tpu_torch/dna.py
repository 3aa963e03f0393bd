"""DNA alphabet machinery: 2-bit codes, IUPAC masks, complements.

Design notes
------------
Sequences are held as ``uint8`` code arrays (A=0, C=1, G=2, T=3, other>=4)
so that every downstream stage is a vectorized array op:

* PAM scanning is an AND-reduction of per-position IUPAC *bit masks*
  over shifted views of the genome (replaces the reference's overlapped
  ``regex.finditer`` C-extension scan, ``guidemaker/core.py:154``).
* Hamming k-NN packs the codes into 64-bit words on the device
  (:func:`guidemaker_tpu_torch.knn.hamming.pack_codes`).

The IUPAC tables mirror the reference semantics
(``guidemaker/core.py:108-122`` and ``core.py:1093-1124``).
"""
from __future__ import annotations

from itertools import product
from typing import List

import numpy as np

# Canonical base order. Code 4 is "anything else" (N, ambiguity codes, gaps).
BASES = "ACGT"
A, C, G, T = 0, 1, 2, 3
INVALID = 4

#: IUPAC ambiguity code -> set of concrete bases (reference core.py:1103-1120).
IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "M": "AC", "R": "AG", "W": "AT", "S": "CG",
    "Y": "CT", "K": "GT", "V": "ACG", "H": "ACT",
    "D": "AGT", "B": "CGT", "X": "GATC", "N": "GATC",
}

_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A",
               "M": "K", "R": "Y", "W": "W", "S": "S",
               "Y": "R", "K": "M", "V": "B", "H": "D",
               "D": "H", "B": "V", "X": "X", "N": "N"}

# ---------------------------------------------------------------------------
# Lookup tables (built once at import).
# ---------------------------------------------------------------------------

#: byte value -> 2-bit code (uint8), case-insensitive; non-ACGT -> INVALID.
BYTE_TO_CODE = np.full(256, INVALID, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    BYTE_TO_CODE[ord(_b)] = _i
    BYTE_TO_CODE[ord(_b.lower())] = _i

#: case-SENSITIVE variant: lowercase (soft-masked) bases are INVALID, matching
#: the reference's case-sensitive regex scan semantics (core.py:154 on
#: upper-cased input from get_fastas, core.py:1082).
STRICT_BYTE_TO_CODE = np.full(256, INVALID, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    STRICT_BYTE_TO_CODE[ord(_b)] = _i

#: code -> byte value of the base character ('A','C','G','T', 'N' for invalid).
CODE_TO_BYTE = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()

#: byte value -> 4-bit base membership mask (A=1, C=2, G=4, T=8); 0 if non-ACGT.
BYTE_TO_BIT = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    BYTE_TO_BIT[ord(_b)] = 1 << _i
    BYTE_TO_BIT[ord(_b.lower())] = 1 << _i

#: code -> 4-bit membership mask (INVALID -> 0 so it never matches a motif).
CODE_TO_BIT = np.array([1, 2, 4, 8, 0], dtype=np.uint8)

#: code -> complementary code (INVALID stays INVALID).
CODE_COMPLEMENT = np.array([T, G, C, A, INVALID], dtype=np.uint8)


def encode(seq: str) -> np.ndarray:
    """Encode a DNA string into a uint8 code array."""
    return BYTE_TO_CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def encode_bytes(buf: bytes) -> np.ndarray:
    """Encode an ASCII byte buffer into a uint8 code array."""
    return BYTE_TO_CODE[np.frombuffer(buf, dtype=np.uint8)]


def encode_batch(seqs, length: int) -> np.ndarray:
    """Encode a list of equal-length strings into an (n, length) code matrix
    with one bulk conversion (no per-string Python loop)."""
    blob = "".join(seqs).encode("ascii")
    codes = BYTE_TO_CODE[np.frombuffer(blob, dtype=np.uint8)]
    return codes.reshape(-1, length)


def encode_pandas(col, length: int = None):
    """pandas Series/array, pyarrow (Chunked)Array, or sequence of
    equal-length strings -> ((n, L) uint8 code matrix, pyarrow
    StringArray of the same values).

    The fast path reads the Arrow string data buffer directly — no
    Python string is ever materialized (measured ~6x faster than
    ``encode_batch`` on a 1.16M x 20 target column, where the
    ``"".join`` alone dominates the index-build stage).  Falls back to
    :func:`encode_batch` for non-Arrow inputs.
    """
    import pyarrow as pa
    import pyarrow.compute as pc
    arr = col if isinstance(col, (pa.Array, pa.ChunkedArray)) \
        else pa.array(col, from_pandas=True)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    if n == 0:
        return np.empty((0, length or 0), np.uint8), arr
    mm = pc.min_max(pc.binary_length(arr))
    mn, mx = mm["min"].as_py(), mm["max"].as_py()
    if length is None:
        length = mx
    if mn != mx or mx != length or arr.null_count:
        raise ValueError("all indexed sequences must share one length")
    bufs = arr.buffers()
    off_dtype = np.int64 if pa.types.is_large_string(arr.type) else np.int32
    offsets = np.frombuffer(bufs[1], dtype=off_dtype)
    start = int(offsets[arr.offset])
    data = np.frombuffer(bufs[2], dtype=np.uint8)
    blob = data[start:start + n * length]
    return BYTE_TO_CODE[blob].reshape(n, length), arr


def decode(codes: np.ndarray) -> str:
    """Decode a uint8 code array back into a DNA string."""
    return CODE_TO_BYTE[codes].tobytes().decode("ascii")


def decode_rows(codes: np.ndarray) -> List[str]:
    """Decode a (n, L) code matrix into n strings (single bulk conversion:
    bytes -> fixed-width S dtype -> U dtype, all in C)."""
    if codes.size == 0:
        return []
    n, length = codes.shape
    # uint8 fancy indexing directly: upcasting the whole matrix to intp
    # first cost 4x the entire conversion
    blob = CODE_TO_BYTE[codes].tobytes()
    return np.frombuffer(blob, dtype=f"S{length}").astype(f"U{length}").tolist()


def rows_to_str_array(codes: np.ndarray, exceptions=None):
    """(n, L) uint8 codes -> pandas ``str``-dtype array, no Python strings.

    The Arrow StringArray is built directly on the decoded byte buffer
    (``decode_rows`` + DataFrame string conversion costs ~6 s for a
    1.2M x 20 matrix; this path is ~0.4 s).  ``exceptions`` maps row
    index -> exact replacement text, used for the few contig-edge context
    windows whose text is shorter than L (or contains characters outside
    the code alphabet); ``codes`` rows may also be pre-decoded ASCII — pass
    them through :data:`CODE_TO_BYTE` yourself in that case via
    ``bytes_rows_to_str_array``.
    """
    return bytes_rows_to_str_array(CODE_TO_BYTE[codes], exceptions)


def bytes_rows_to_str_array(byte_rows: np.ndarray, exceptions=None):
    """(n, L) uint8 ASCII byte matrix -> pandas ``str``-dtype array."""
    import pandas as pd
    import pyarrow as pa
    n, length = byte_rows.shape
    if not exceptions:
        # mirror the exceptions path: int32 offsets silently wrap past
        # 2^31 bytes (~107M 20-mers), so switch to LargeStringArray there
        if n * length <= np.iinfo(np.int32).max:
            offsets = np.arange(0, (n + 1) * length, length, dtype=np.int32)
            arr = pa.StringArray.from_buffers(
                n, pa.py_buffer(offsets),
                pa.py_buffer(np.ascontiguousarray(byte_rows)))
        else:
            offsets = np.arange(0, (n + 1) * length, length, dtype=np.int64)
            arr = pa.LargeStringArray.from_buffers(
                n, pa.py_buffer(offsets),
                pa.py_buffer(np.ascontiguousarray(byte_rows)))
        return pd.array(arr, dtype="str")
    exc = {int(i): s.encode("ascii") for i, s in exceptions.items()}
    lens = np.full(n, length, dtype=np.int64)
    for i, b in exc.items():
        lens[i] = len(b)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = np.empty(int(offsets[-1]), dtype=np.uint8)
    prev = 0
    for i in sorted(exc) + [n]:   # bulk-copy runs between exception rows
        if i > prev:
            data[offsets[prev]:offsets[i]] = byte_rows[prev:i].reshape(-1)
        if i < n:
            data[offsets[i]:offsets[i + 1]] = np.frombuffer(exc[i], np.uint8)
        prev = i + 1
    if offsets[-1] <= np.iinfo(np.int32).max:
        arr = pa.StringArray.from_buffers(
            n, pa.py_buffer(offsets.astype(np.int32)), pa.py_buffer(data))
    else:
        arr = pa.LargeStringArray.from_buffers(
            n, pa.py_buffer(offsets), pa.py_buffer(data))
    return pd.array(arr, dtype="str")


def revcomp_codes(codes: np.ndarray, axis: int = -1) -> np.ndarray:
    """Reverse-complement along ``axis`` of a code array."""
    return np.flip(CODE_COMPLEMENT[codes], axis=axis)


_COMPLEMENT_TABLE = str.maketrans(
    "".join(_COMPLEMENT.keys()) + "".join(_COMPLEMENT.keys()).lower(),
    "".join(_COMPLEMENT.values()) + "".join(_COMPLEMENT.values()).lower(),
)


def reverse_complement(seq: str) -> str:
    """Reverse complement of an IUPAC DNA string (reference core.py:95-106).

    Unknown characters are kept as-is (Biopython-compatible).
    """
    return seq.translate(_COMPLEMENT_TABLE)[::-1]


def pam_bit_masks(pam: str) -> np.ndarray:
    """IUPAC motif -> per-position 4-bit membership masks (uint8 of len(pam)).

    ``mask[j] & CODE_TO_BIT[genome[i+j]] != 0`` iff base ``i+j`` matches
    motif position ``j``; the AND-reduction over ``j`` replaces the
    reference's regex char-class scan (core.py:108-122).
    """
    masks = np.zeros(len(pam), dtype=np.uint8)
    for j, letter in enumerate(pam.upper()):
        for base in IUPAC[letter]:
            masks[j] |= 1 << BASES.index(base)
    return masks


def extend_ambiguous_dna(seq: str) -> List[str]:
    """All concrete sequences for an ambiguous IUPAC string.

    Order matches the reference (itertools.product over IUPAC value strings,
    core.py:1093-1124) so golden tests on ordering hold.
    """
    return ["".join(p) for p in product(*[IUPAC[ch] for ch in seq.upper()])]


def gc_fraction(seq: str) -> float:
    """Fraction of G/C bases (Biopython-compatible for ACGT strings)."""
    if not seq:
        return 0.0
    s = seq.upper()
    return (s.count("G") + s.count("C") + s.count("S")) / len(s)
