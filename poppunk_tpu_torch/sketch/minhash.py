"""BinDash-style b-bit one-permutation MinHash sketching.

Scheme (algorithm lineage per the reference's citation of BinDash + ntHash,
PopPUNK/citation.py:31-43; schema per PopPUNK/web.py:14-61 and
test/json_sketch.txt — bbits=14, sketchsize64=156, usigs length
sketchsize64*bbits uint64):

1. Every valid canonical k-mer hash h is reduced to a *sign*
   ``s = h % SIGN_MOD`` with ``SIGN_MOD = 2**61 - 1``.
2. The sign space is range-partitioned into ``S = sketchsize64 * 64`` bins of
   width ``binsize = ceil(SIGN_MOD / S)``; each bin keeps the minimum sign
   that lands in it (one-permutation MinHash).
3. Empty bins are filled by *optimal densification* (Shrivastava 2017):
   bin i takes the value of bin ``probe(i, attempt)`` for the first attempt
   that hits a non-empty bin, where probe is a 64-bit mix of (i, attempt).
4. The lowest ``bbits`` bits of each bin's sign are kept, packed as bit
   planes: ``usigs[w * bbits + p]`` bit m holds bit p of the sign of bin
   ``w * 64 + m`` (interleaved plane layout, matching the reference HDF5
   dataset shape ``sketchsize64 * bbits`` uint64).

Jaccard estimation from two sketches counts bins whose bbits-bit values
agree on all planes, then corrects for chance collisions:
``J = (matches/S - 2^-b) / (1 - 2^-b)`` — see ops/jaccard_np.py and ops/pallas_jaccard.py.

The exact bit patterns are self-consistent within this framework (they are
not guaranteed bit-identical to pp-sketchlib, whose source is not part of
the reference checkout; the estimator and schema are the same).

Copied from ``poppunk_tpu/sketch/minhash.py``, whose counterpart it is: this
package imports nothing of the JAX package.
"""

from dataclasses import dataclass

import numpy as np

from .nthash import nthash_canonical, nthash_forward, INVALID_BASE

SIGN_MOD = np.uint64((1 << 61) - 1)
DEFAULT_BBITS = 14
DEFAULT_SKETCHSIZE64 = 156  # sketch size 9984 / 64 (reference __main__.py:317)
EMPTY_BIN = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclass
class SketchParams:
    klist: tuple
    sketchsize64: int = DEFAULT_SKETCHSIZE64
    bbits: int = DEFAULT_BBITS
    use_rc: bool = True
    codon_phased: bool = False
    min_count: int = 0
    exact_counter: bool = False

    @property
    def nbins(self):
        return self.sketchsize64 * 64


@dataclass
class Sketch:
    """One sample's sketch: per-k packed bit planes + metadata."""

    name: str
    usigs: dict  # k -> uint64[sketchsize64 * bbits]
    sketchsize64: int
    bbits: int
    length: int
    missing_bases: int
    base_freq: np.ndarray  # ACGT frequencies
    densified: bool = False
    reads: bool = False


def _mix64(x):
    """splitmix64 finaliser — used for densification probing."""
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
    return z


def bin_signs(hashes, nbins):
    """One-permutation binning: min sign per bin (EMPTY_BIN if none).

    Vectorised: a single sort of the signs gives the per-bin minimum as the
    first occurrence of each bin index.
    """
    signs = np.full(nbins, EMPTY_BIN, dtype=np.uint64)
    if hashes.size == 0:
        return signs
    # x % SIGN_MOD via floordiv (the uint64 mod ufunc is slow on this host)
    s = hashes - (hashes // SIGN_MOD) * SIGN_MOD
    binsize = (SIGN_MOD + np.uint64(nbins) - np.uint64(1)) // np.uint64(nbins)
    s.sort()
    binidx = (s // binsize).astype(np.int64)
    first = np.unique(binidx, return_index=True)
    signs[first[0]] = s[first[1]]
    return signs


def densify(signs):
    """Optimal densification: fill empty bins from probed non-empty bins.

    Each empty bin i takes the value of the first non-empty bin hit by the
    probe sequence ``mix(i, attempt) % nbins`` — all empty bins are probed in
    lockstep (vectorised), one attempt per loop iteration.

    Returns (signs, was_densified). All-empty input raises.
    """
    empty = signs == EMPTY_BIN
    if not empty.any():
        return signs, False
    if empty.all():
        raise ValueError("Sequence too short to sketch: no k-mers hashed")
    signs = signs.copy()
    nbins = signs.shape[0]
    nonempty = ~empty
    orig = np.flatnonzero(empty)
    donor = np.full(orig.shape[0], -1, dtype=np.int64)
    unfilled = np.arange(orig.shape[0])
    attempt = 0
    while unfilled.size:
        probe = (
            _mix64(orig[unfilled].astype(np.uint64) ^ _mix64(np.uint64(attempt)))
            % np.uint64(nbins)
        ).astype(np.int64)
        hit = nonempty[probe]
        donor[unfilled[hit]] = probe[hit]
        unfilled = unfilled[~hit]
        attempt += 1
        if attempt > 100000:  # unreachable: success prob/attempt = frac non-empty
            raise RuntimeError("densification did not converge")
    signs[orig] = signs[donor]
    return signs, True


def pack_bbits(signs, sketchsize64, bbits):
    """Pack the low ``bbits`` of each bin sign into interleaved bit planes.

    Layout: usigs[w * bbits + p] bit m = bit p of signs[w * 64 + m]
    (the reference HDF5 datasets have this sketchsize64*bbits shape).
    """
    signs = signs.reshape(sketchsize64, 64)
    bit_m = np.arange(64, dtype=np.uint64)
    usigs = np.zeros((sketchsize64, bbits), dtype=np.uint64)
    for p in range(bbits):
        bits = (signs >> np.uint64(p)) & np.uint64(1)
        usigs[:, p] = np.bitwise_or.reduce(bits << bit_m, axis=1)
    return usigs.reshape(-1)


def unpack_bbits(usigs, sketchsize64, bbits):
    """Inverse of :func:`pack_bbits`: per-bin bbits-bit values (for tests)."""
    planes = usigs.reshape(sketchsize64, bbits)
    bit_m = np.arange(64, dtype=np.uint64)
    vals = np.zeros((sketchsize64, 64), dtype=np.uint64)
    for p in range(bbits):
        bits = (planes[:, p][:, None] >> bit_m) & np.uint64(1)
        vals |= bits << np.uint64(p)
    return vals.reshape(-1)


def _phase_hashes(codes, k, use_rc, codon_phased):
    """Canonical (or forward) hashes of all valid windows."""
    if codon_phased:
        # Codon-phased spaced seeds X--X--X..: hash every third base over a
        # window spanning 3k-2 bases, for each of the 3 phase offsets.
        hashes = []
        for phase in range(3):
            sub = codes[phase::3]
            h, valid = (nthash_canonical if use_rc else nthash_forward)(sub, k)
            # a spaced window is valid iff all sampled bases are valid AND the
            # full span lies within the sequence; sampled-base validity is
            # what nthash on the subsequence checks.
            hashes.append(h[valid])
        return np.concatenate(hashes) if hashes else np.empty(0, np.uint64)
    h, valid = (nthash_canonical if use_rc else nthash_forward)(codes, k)
    return h[valid]


def sketch_codes(codes, params: SketchParams, reads=False, use_native=None,
                 native_threads=None):
    """Sketch an encoded base array at every k in params.klist.

    Returns dict k -> packed usigs, plus densified flag.

    The native C++ core (native/sketch_core.cpp, bit-identical) handles
    every input mode: assemblies, reads (exact / count-min k-mer
    filtering) and codon-phased spaced seeds. ``native_threads=1`` keeps
    the per-genome OpenMP span out of the way when the caller runs a
    process pool across genomes.
    """
    from .reader import filter_read_kmers

    if use_native is None:
        use_native = True
    if use_native:
        from .native import sketch_codes_native

        native = sketch_codes_native(codes, params, threads=native_threads,
                                     reads=reads)
        if native is not None:
            return native

    usigs = {}
    densified_any = False
    for k in params.klist:
        hashes = _phase_hashes(codes, int(k), params.use_rc, params.codon_phased)
        if reads and params.min_count > 0:
            hashes = filter_read_kmers(hashes, params.min_count, params.exact_counter)
        signs = bin_signs(hashes, params.nbins)
        signs, dens = densify(signs)
        densified_any = densified_any or dens
        usigs[int(k)] = pack_bbits(signs, params.sketchsize64, params.bbits)
    return usigs, densified_any


def sketch_sequence(name, codes, params: SketchParams, length=None,
                    missing_bases=None, reads=False,
                    native_threads=None) -> Sketch:
    """Sketch one sample from its encoded (possibly concatenated) bases."""
    real = codes != INVALID_BASE
    n_real = int(real.sum())
    counts = np.bincount(codes[real], minlength=4)[:4]
    base_freq = counts / max(n_real, 1)
    if missing_bases is None:
        missing_bases = int(codes.shape[0] - n_real)
    if length is None:
        length = int(codes.shape[0])
    usigs, densified = sketch_codes(codes, params, reads=reads,
                                    native_threads=native_threads)
    return Sketch(
        name=name,
        usigs=usigs,
        sketchsize64=params.sketchsize64,
        bbits=params.bbits,
        length=length,
        missing_bases=missing_bases,
        base_freq=base_freq.astype(np.float64),
        densified=densified,
        reads=reads,
    )
