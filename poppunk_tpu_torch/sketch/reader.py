"""Sequence ingestion: FASTA assemblies and FASTQ reads (plain or gzip).

Contigs are concatenated with a single invalid-base separator so k-mer
windows never span a contig junction (windows containing the separator are
dropped by the hash validity mask). ``length`` and ``missing_bases`` count
only real sequence, matching the attrs the reference stores per sample
(PopPUNK/web.py:42-50).

For reads (FASTQ), k-mers below ``min_count`` occurrences are filtered with
either an exact counter or a count-min sketch — the same two modes the
reference exposes (--exact-count / countmin, PopPUNK/__main__.py:83-86).
Read inputs skip ambiguous-base QC downstream (PopPUNK/qc.py:189-193).

Copied from ``poppunk_tpu/sketch/reader.py``, whose counterpart it is: this
package imports nothing of the JAX package.
"""

import gzip
import io
import os

import numpy as np

from .nthash import encode_bases, INVALID_BASE

_SEPARATOR = np.array([INVALID_BASE], dtype=np.uint8)


def _open_maybe_gzip(path):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _is_fastq(path):
    with _open_maybe_gzip(path) as fh:
        first = fh.read(1)
    return first == b"@"


def read_fasta_codes(path):
    """Encoded bases of all contigs, separator-joined.

    Returns (codes, length, missing_bases).
    """
    chunks = []
    with _open_maybe_gzip(path) as fh:
        data = fh.read()
    length = 0
    missing = 0
    pieces = []
    for line in data.split(b"\n"):
        if not line or line.startswith(b";"):
            continue
        if line.startswith(b">"):
            if pieces:
                chunks.append(np.frombuffer(b"".join(pieces), dtype=np.uint8))
                pieces = []
            continue
        pieces.append(line.strip())
    if pieces:
        chunks.append(np.frombuffer(b"".join(pieces), dtype=np.uint8))
    if not chunks:
        raise RuntimeError(f"No sequence found in {path}")

    coded = []
    for contig in chunks:
        codes = encode_bases(contig)
        length += codes.shape[0]
        missing += int((codes == INVALID_BASE).sum())
        coded.append(codes)
        coded.append(_SEPARATOR)
    return np.concatenate(coded[:-1]), length, missing


def read_fastq_codes(path):
    """Encoded bases of all reads, separator-joined.

    Returns (codes, length, missing_bases). Length counts read bases.

    Vectorised: a 10x-coverage genome is ~100k reads, and per-read numpy
    calls cost more than the sketching itself. All sequence lines are
    joined with a NUL separator (NUL encodes to INVALID_BASE, exactly
    the per-read separator semantics) and encoded in one pass.
    """
    with _open_maybe_gzip(path) as fh:
        data = fh.read()
    if b"\r" in data:  # CRLF input: normalise once
        data = data.replace(b"\r", b"")
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    n_rec = len(lines) // 4
    if n_rec == 0 or len(lines) % 4:
        raise RuntimeError(f"No reads found in {path}"
                           if n_rec == 0 else
                           f"Malformed FASTQ (truncated record) in {path}")
    for i in range(0, len(lines), 4):
        if not lines[i].startswith(b"@"):
            raise RuntimeError(f"Malformed FASTQ at line {i} in {path}")
    seqs = lines[1::4]
    joined = b"\x00".join(seqs)
    codes = encode_bases(np.frombuffer(joined, dtype=np.uint8))
    n_sep = n_rec - 1
    length = len(joined) - n_sep
    missing = int((codes == INVALID_BASE).sum()) - n_sep
    return codes, length, missing


def read_sequence_input(files):
    """Read one sample's input file list into a single encoded array.

    Returns (codes, length, missing_bases, is_reads).
    """
    if isinstance(files, (str, os.PathLike)):
        files = [files]
    all_codes = []
    total_len = 0
    total_missing = 0
    any_reads = False
    for path in files:
        if _is_fastq(path):
            codes, length, missing = read_fastq_codes(path)
            any_reads = True
        else:
            codes, length, missing = read_fasta_codes(path)
        all_codes.append(codes)
        all_codes.append(_SEPARATOR)
        total_len += length
        total_missing += missing
    return np.concatenate(all_codes[:-1]), total_len, total_missing, any_reads


def countmin_cap(min_count):
    """Counter saturation cap for a min_count: the filter only needs to
    distinguish counts below min_count from counts at/above it, so
    counters saturate at the next power-of-two-minus-one >= min_count
    (2-bit fields for min_count <= 3, 4-bit for <= 15, ...). The native
    core packs fields at this width so the whole table stays
    cache-resident; est >= min_count decisions are identical to
    unbounded counters. Change reader.py and sketch_core.cpp together."""
    bits = 2
    while (1 << bits) - 1 < min_count:
        bits *= 2
    return (1 << bits) - 1


class CountMin:
    """Count-min sketch k-mer counter for read filtering.

    Matches the role (not the exact table geometry) of the reference's
    countmin counter: k-mers whose estimated count is below ``min_count``
    are excluded from sketching. Counters saturate at ``cap`` (see
    countmin_cap) — estimates are exact below the cap and the
    ``est >= min_count`` filter decision is exact always.
    """

    def __init__(self, width_bits=22, hashes=4, cap=None):
        self.width = 1 << width_bits
        self.mask = np.uint64(self.width - 1)
        self.hashes = hashes
        self.cap = np.uint32(cap) if cap is not None else None
        self.table = np.zeros((hashes, self.width), dtype=np.uint32)
        self._salts = np.arange(1, hashes + 1, dtype=np.uint64) * np.uint64(
            0x9E3779B97F4A7C15
        )

    def add_and_count(self, hashes):
        """Insert all hashes; return the estimated (saturated) count of
        each, read after all insertions."""
        est = np.full(hashes.shape[0], np.iinfo(np.uint32).max,
                      dtype=np.uint32)
        for row in range(self.hashes):
            idx = ((hashes * self._salts[row]) >> np.uint64(33)) & self.mask
            idx = idx.astype(np.int64)
            np.add.at(self.table[row], idx, 1)
            est = np.minimum(est, self.table[row][idx])
        if self.cap is not None:
            est = np.minimum(est, self.cap)
        return est


def filter_read_kmers(hashes, min_count, exact=False):
    """Filter k-mer hashes of read data by multiplicity."""
    if min_count <= 1 or hashes.size == 0:
        return hashes
    if exact:
        uniq, counts = np.unique(hashes, return_counts=True)
        keep = uniq[counts >= min_count]
        return np.repeat(keep, counts[counts >= min_count])
    cm = CountMin(cap=countmin_cap(min_count))
    est = cm.add_and_count(hashes)
    return hashes[est >= min_count]
