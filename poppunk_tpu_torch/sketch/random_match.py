"""Expected Jaccard of random (unrelated) sequences.

Role: the reference corrects observed per-k Jaccards for the matches two
unrelated genomes of similar composition would share by chance
(pp_sketchlib's ``random_correct=True`` / ``addRandom``; wired at
PopPUNK/sketchlib.py:437-473,533). pp-sketchlib stores a clustered
approximation table in the HDF5 ``random`` group; our redesign computes the
correction *exactly per pair* from each sample's length and base frequency
(both already stored per sketch), so no table is needed — ``addRandom``
becomes a cheap marker. This is vectorisable over all pairs on device.

Model (Bernoulli, closed form): for genomes with base frequency vectors
f1, f2 and k-mer counts n1, n2 (length - k + 1):

    m_f  = sum_b f1[b] * f2[b]          (per-base match prob, same strand)
    m_rc = sum_b f1[b] * f2[comp(b)]    (vs reverse complement)
    p    = m_f**k (+ m_rc**k if canonical k-mers)   per k-mer-pair match prob

    E|A ∩ B| ≈ n1 * n2 * p    (expected matching cross pairs)
    E[J_random] ≈ n1*n2*p / (n1 + n2 - n1*n2*p),  clipped to [0, 1)

This is the Mash-style null expectation with composition awareness; like the
reference it only needs lengths + base frequencies.

Copied from ``poppunk_tpu/sketch/random_match.py``, whose counterpart it is:
this package imports nothing of the JAX package.
"""

import numpy as np

_COMP_PERM = np.array([3, 2, 1, 0])  # A<->T, C<->G in ACGT order


def random_jaccard(k, length1, length2, base_freq1, base_freq2, use_rc=True):
    """Expected Jaccard under the null for one pair, one k. Vectorises over
    leading dimensions of the inputs."""
    f1 = np.asarray(base_freq1, dtype=np.float64)
    f2 = np.asarray(base_freq2, dtype=np.float64)
    m_f = (f1 * f2).sum(axis=-1)
    p = m_f ** k
    if use_rc:
        m_rc = (f1 * f2[..., _COMP_PERM]).sum(axis=-1)
        p = p + m_rc ** k
    n1 = np.maximum(np.asarray(length1, dtype=np.float64) - k + 1, 1.0)
    n2 = np.maximum(np.asarray(length2, dtype=np.float64) - k + 1, 1.0)
    inter = n1 * n2 * p
    union = n1 + n2 - inter
    r = np.where(union <= 0, 1.0, inter / np.maximum(union, 1e-30))
    return np.clip(r, 0.0, 1.0 - 1e-6)


def random_jaccard_table(klist, lengths, base_freqs, use_rc=True):
    """All-pairs random Jaccard: returns float32[len(klist), n, n].

    lengths: int[n]; base_freqs: float[n, 4].
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    freqs = np.asarray(base_freqs, dtype=np.float64)
    n = lengths.shape[0]
    out = np.zeros((len(klist), n, n), dtype=np.float32)
    for ki, k in enumerate(klist):
        m_f = freqs @ freqs.T
        p = m_f ** k
        if use_rc:
            m_rc = freqs @ freqs[:, _COMP_PERM].T
            p = p + m_rc ** k
        nk = np.maximum(lengths - k + 1, 1.0)
        inter = np.outer(nk, nk) * p
        union = nk[:, None] + nk[None, :] - inter
        r = np.where(union <= 0, 1.0, inter / np.maximum(union, 1e-30))
        out[ki] = np.clip(r, 0.0, 1.0 - 1e-6).astype(np.float32)
    return out
