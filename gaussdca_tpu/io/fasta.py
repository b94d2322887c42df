"""Host-side MSA ingest: (gzipped) FASTA -> uint8 token matrix.

Reproduces the ingest contract the reference consumes from DCAUtils'
``read_fasta_alignment`` (called at /root/reference/src/GaussDCA.jl:20):

- transparent gzip handling (both bundled test alignments are ``.gz``),
- insert states (lowercase letters and ``.``) are removed per sequence,
- sequences whose gap fraction exceeds ``max_gap_fraction`` are dropped
  (boundary inclusive: a sequence is kept iff ``ngaps/N <= max_gap_fraction``),
- letters map to ``1..21``: the 20 standard amino acids in alphabetical
  order get 1..20 and everything else (gap ``-``, B, J, O, U, X, Z, ...)
  maps to 21,
- ragged post-filter lengths are an error.

The output is sequence-major ``[M, N]`` (the reference is position-major
``N x M``; sequence-major is the natural layout for the device pipeline where
M is the data-parallel axis). Parsing happens on the host: a native C++
parser (native/fasta_native.cpp, loaded via io/native.py) when available,
else the pure-NumPy implementation here — the two are cross-validated in
tests/test_native_io.py. Tokens are transferred to device once,
downstream of dedup.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np

GAP_STATE = 21

# A..Y -> state; the 20 standard amino acids in alphabetical order get 1..20,
# non-standard letters collapse onto the gap state 21.
_LETTER_STATES = {
    "A": 1, "C": 2, "D": 3, "E": 4, "F": 5, "G": 6, "H": 7, "I": 8,
    "K": 9, "L": 10, "M": 11, "N": 12, "P": 13, "Q": 14, "R": 15,
    "S": 16, "T": 17, "V": 18, "W": 19, "Y": 20,
}

_LUT = np.full(256, GAP_STATE, dtype=np.uint8)
for _c, _v in _LETTER_STATES.items():
    _LUT[ord(_c)] = _v

# Insert-state bytes removed per sequence: lowercase a-z and '.'.
_INSERT = np.zeros(256, dtype=bool)
for _b in range(ord("a"), ord("z") + 1):
    _INSERT[_b] = True
_INSERT[ord(".")] = True

_GAP_BYTE = ord("-")


@dataclasses.dataclass
class MSA:
    """A tokenized multiple sequence alignment.

    tokens: uint8 [M, N], states in 1..q.
    headers: the M FASTA headers (without the leading '>').
    q: alphabet size = max observed state (21 for standard protein data).
    n_dropped_gaps: sequences removed by the gap-fraction filter.
    """

    tokens: np.ndarray
    headers: List[str]
    q: int
    n_dropped_gaps: int = 0
    n_dropped_dups: int = 0

    @property
    def M(self) -> int:
        return self.tokens.shape[0]

    @property
    def N(self) -> int:
        return self.tokens.shape[1]


# Line-edge trim set: every byte <= 0x20, exactly like the native
# parser's `(unsigned char)c <= ' '` edge strip — str.strip() would miss
# control bytes like \x01, making the two parsers disagree on width.
_EDGE_BYTES = bytes(range(0x21))


def _read_bytes(path: str) -> bytes:
    """The whole (decompressed) file as bytes, with zlib's tolerant
    gzip semantics: concatenated members are all decoded, trailing
    bytes that are not a gzip member are ignored (Python's ``gzip``
    module raises BadGzipFile there — the native parser's zlib path
    accepts such files, and the two parsers must agree), a truncated
    member is an error."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if not raw.startswith(b"\x1f\x8b"):
        return raw
    import zlib

    out: List[bytes] = []
    pos = 0
    while raw[pos:pos + 2] == b"\x1f\x8b":
        d = zlib.decompressobj(wbits=31)
        try:
            out.append(d.decompress(raw[pos:]))
            out.append(d.flush())
        except zlib.error as e:
            raise ValueError(f"error reading {path}: {e}")
        if not d.eof:
            raise ValueError(
                f"error reading {path}: truncated gzip member")
        unused = len(d.unused_data)
        if unused == 0:
            break
        pos = len(raw) - unused
    return b"".join(out)


def _read_records(path: str) -> List[Tuple[str, bytes]]:
    """FASTA records as (header, sequence-bytes), parsed in BYTES mode.

    Byte-for-byte the native parser's line semantics: lines are edge-
    trimmed of bytes <= 0x20, arbitrary non-ASCII sequence bytes are
    legal (they tokenize to the gap state downstream), and headers
    decode as UTF-8 with replacement — text-mode reading would instead
    raise UnicodeDecodeError on bytes the native parser accepts,
    breaking the cross-validated-parity contract.
    """
    records: List[Tuple[str, bytes]] = []
    header = None
    chunks: List[bytes] = []
    for line in _read_bytes(path).split(b"\n"):
        line = line.strip(_EDGE_BYTES)
        if not line:
            continue
        if line.startswith(b">"):
            if header is not None:
                records.append((header, b"".join(chunks)))
            header = line[1:].decode("utf-8", "replace")
            chunks = []
        else:
            if header is None:
                raise ValueError(
                    f"invalid FASTA file {path}: sequence data before "
                    "the first header")
            chunks.append(line)
    if header is not None:
        records.append((header, b"".join(chunks)))
    if not records:
        raise ValueError(f"invalid FASTA file {path}: no sequences found")
    return records


def read_fasta_alignment(path: str, max_gap_fraction: float, *,
                         use_native: bool = True) -> MSA:
    """Parse a (gzipped) FASTA alignment into an MSA token matrix.

    Matches the DCAUtils ``read_fasta_alignment(filename, max_gap_fraction)``
    contract consumed at src/GaussDCA.jl:20 (see module docstring), except
    the output is sequence-major [M, N]. Uses the native C++ parser when
    available (``use_native=False`` or GDCA_NO_NATIVE=1 forces NumPy).
    """
    if not os.path.isfile(path):
        raise ValueError(f"cannot open file {path}")

    if use_native:
        from gaussdca_tpu.io import native
        parsed = native.parse_fasta(path, max_gap_fraction)
        if parsed is not None:
            tokens, headers, q, n_dropped = parsed
            return MSA(tokens=tokens, headers=headers, q=q,
                       n_dropped_gaps=n_dropped)

    records = _read_records(path)

    rows: List[np.ndarray] = []
    headers: List[str] = []
    n_dropped = 0
    width = None
    for header, seq in records:
        raw = np.frombuffer(seq, dtype=np.uint8)
        kept = raw[~_INSERT[raw]]
        if width is None:
            width = kept.size
            if width == 0:
                raise ValueError(
                    f"invalid FASTA file {path}: empty first sequence")
        elif kept.size != width:
            raise ValueError(
                f"invalid FASTA file {path}: sequences have inconsistent "
                f"lengths ({kept.size} != {width})")
        ngaps = int(np.count_nonzero(kept == _GAP_BYTE))
        if ngaps / width > max_gap_fraction:
            n_dropped += 1
            continue
        rows.append(_LUT[kept])
        headers.append(header)

    if not rows:
        raise ValueError(
            f"invalid FASTA file {path}: all sequences exceed "
            f"max_gap_fraction={max_gap_fraction}")

    tokens = np.stack(rows)
    q = int(tokens.max())
    return MSA(tokens=tokens, headers=headers, q=q, n_dropped_gaps=n_dropped)


def remove_duplicate_sequences(msa: MSA) -> MSA:
    """Drop exact duplicate sequences, keeping first occurrences in order.

    Matches DCAUtils ``remove_duplicate_sequences`` as consumed at
    src/GaussDCA.jl:21-23 (second return value, the kept indices, is
    exposed via headers).
    """
    _, first_idx = np.unique(msa.tokens, axis=0, return_index=True)
    keep = np.sort(first_idx)
    dropped = msa.M - keep.size
    return MSA(
        tokens=msa.tokens[keep],
        headers=[msa.headers[i] for i in keep],
        q=msa.q,
        n_dropped_gaps=msa.n_dropped_gaps,
        n_dropped_dups=dropped,
    )


def tokens_from_sequences(seqs: Sequence[str]) -> MSA:
    """Build an MSA directly from python strings (testing convenience)."""
    rows = [_LUT[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]
            for s in seqs]
    tokens = np.stack(rows)
    return MSA(tokens=tokens, headers=[f"seq{i}" for i in range(len(rows))],
               q=int(tokens.max()))
