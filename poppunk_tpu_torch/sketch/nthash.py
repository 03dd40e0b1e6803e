"""Vectorised ntHash rolling k-mer hashing.

ntHash (Mohamadi et al. 2016) computes a 64-bit hash of each k-mer window as
an XOR of per-base seed constants, each rotated by the base's distance from
the window end:

    fh(j) = XOR_{i=j..j+k-1} rol64(seed[s_i], j + k - 1 - i)

The recursive/rolling form used by scalar implementations is replaced here
with a closed-form prefix-XOR formulation that vectorises over the whole
sequence (no Python loop over positions):

    rol distributes over XOR, so with u_i = ror64(seed[s_i], i mod 64):
        fh(j) = rol64( P[j+k] ^ P[j], (j + k - 1) mod 64 )
    where P is the prefix-XOR of u.

The reverse-complement hash has the same structure with v_i =
rol64(seed[~s_i], i mod 64) and a right rotation by j:

    rh(j) = ror64( Q[j+k] ^ Q[j], j mod 64 )

The canonical hash is min(fh, rh), matching ntHash's NTC64 convention of
taking the smaller of the two strand hashes.

Performance notes (this numpy build has no SIMD path for variable uint64
shifts — ~150ns/element): rotations that depend only on ``i mod 64`` are a
gather from a precomputed 64 x 5 rotated-seed table, and the final
data-dependent positional rotation is applied column-wise after reshaping to
[-1, 64] so every shift is by a scalar. Net effect: ~60x faster than naive
per-element rotates.

Seed constants are the published ntHash v1 per-base constants.

Copied from ``poppunk_tpu/sketch/nthash.py``, whose counterpart it is: this
package imports nothing of the JAX package.
"""

import numpy as np

# Published ntHash per-base 64-bit seeds (A, C, G, T).
SEED_A = np.uint64(0x3C8BFBB395C60474)
SEED_C = np.uint64(0x3193C18562A02B4C)
SEED_G = np.uint64(0x20323ED082572324)
SEED_T = np.uint64(0x295549F54BE24456)

# Base encoding: A=0, C=1, G=2, T=3, invalid=4 (Ns, contig separators, ...)
INVALID_BASE = 4

_SEED_TABLE = np.array([SEED_A, SEED_C, SEED_G, SEED_T, 0], dtype=np.uint64)
# Complement: A<->T, C<->G; invalid stays invalid
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
_SEED_TABLE_RC = _SEED_TABLE[_COMP]

_ASCII_LUT = np.full(256, INVALID_BASE, dtype=np.uint8)
for _chars, _code in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3)):
    for _ch in _chars:
        _ASCII_LUT[ord(_ch)] = _code


def _rol64_scalar_table(table, shifts):
    """rol64 of each table entry by each shift -> [len(shifts), len(table)]."""
    out = np.empty((len(shifts), len(table)), dtype=np.uint64)
    for r, s in enumerate(shifts):
        s = int(s) % 64
        if s == 0:
            out[r] = table
        else:
            out[r] = (table << np.uint64(s)) | (table >> np.uint64(64 - s))
    return out


# TAB_U[r, b] = rol64(seed[b], (64 - r) % 64)   (i.e. ror64 by r = i mod 64)
_TAB_U = _rol64_scalar_table(_SEED_TABLE, [(64 - r) % 64 for r in range(64)])
# TAB_V[r, b] = rol64(seed_rc[b], r)
_TAB_V = _rol64_scalar_table(_SEED_TABLE_RC, list(range(64)))


def encode_bases(seq_bytes):
    """Map an ASCII uint8 array to 2-bit base codes (invalid -> 4)."""
    return _ASCII_LUT[seq_bytes]


def _positional_gather(table, codes):
    """out[i] = table[i % 64, codes[i]] as one flat gather.

    uint16 flat indices: this numpy build gathers ~20x faster with narrow
    index dtypes than with int64.
    """
    n = codes.shape[0]
    ncols = table.shape[1]
    pattern = (np.arange(64, dtype=np.uint16) * ncols)
    reps = (n + 63) // 64
    rot = np.tile(pattern, reps)[:n]
    flat_idx = rot + codes.astype(np.uint16)
    return table.reshape(-1)[flat_idx]


def _rol_positional(x, mult, offset):
    """rol64(x[j], (mult * j + offset) mod 64) with mult in {+1, -1}.

    Groups positions by j mod 64 (constant shift per column after reshaping
    to [-1, 64]). Shifts use multiply / floor-divide, which (unlike the
    uint64 shift ufuncs) are SIMD-fast in this numpy build.
    """
    n = x.shape[0]
    pad = (-n) % 64
    if pad:
        x = np.concatenate([x, np.zeros(pad, dtype=np.uint64)])
    m = x.reshape(-1, 64)
    out = np.empty_like(m)
    with np.errstate(over="ignore"):
        for c in range(64):
            s = (mult * c + offset) % 64
            col = m[:, c]
            if s == 0:
                out[:, c] = col
            else:
                out[:, c] = (col * np.uint64(1 << s)) | (col // np.uint64(1 << (64 - s)))
    return out.reshape(-1)[:n] if pad else out.reshape(-1)


def _window_valid(codes, k):
    """Boolean per window start: window of length k contains no invalid base."""
    invalid = (codes == INVALID_BASE).astype(np.int32)
    csum = np.concatenate([np.zeros(1, np.int32), np.cumsum(invalid)])
    return (csum[k:] - csum[:-k]) == 0


def _window_xor(u, k):
    p = np.zeros(u.shape[0] + 1, dtype=np.uint64)
    np.bitwise_xor.accumulate(u, out=p[1:])
    return p[k:] ^ p[:-k]


def nthash_forward(codes, k):
    """Forward-strand ntHash for every window; returns (hashes, valid)."""
    n = codes.shape[0]
    if n < k:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    u = _positional_gather(_TAB_U, codes)
    w = _window_xor(u, k)
    fh = _rol_positional(w, 1, (k - 1) % 64)
    return fh, _window_valid(codes, k)


def nthash_canonical(codes, k):
    """Canonical (strand-independent) ntHash for every window.

    Returns (hashes, valid) where hashes[j] = min(fh(j), rh(j)).
    """
    n = codes.shape[0]
    if n < k:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    u = _positional_gather(_TAB_U, codes)
    fh = _rol_positional(_window_xor(u, k), 1, (k - 1) % 64)
    v = _positional_gather(_TAB_V, codes)
    rh = _rol_positional(_window_xor(v, k), -1, 0)
    return np.minimum(fh, rh), _window_valid(codes, k)


def _rol64_one(x, s):
    s = int(s) % 64
    if s == 0:
        return np.uint64(x)
    x = np.uint64(x)
    return np.uint64(((int(x) << s) | (int(x) >> (64 - s))) & 0xFFFFFFFFFFFFFFFF)


def nthash_scalar(kmer_codes):
    """Reference scalar forward hash of one k-mer (for tests)."""
    k = len(kmer_codes)
    h = np.uint64(0)
    for i, c in enumerate(kmer_codes):
        h ^= _rol64_one(_SEED_TABLE[c], k - 1 - i)
    return h
