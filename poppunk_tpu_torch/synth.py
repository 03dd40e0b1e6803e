"""Device-side synthetic population sketch generator.

Counterpart of poppunk_tpu/synth.py: populations of bit-plane sketches
with PopPUNK-like strain structure, drawn directly on the device into the
plane-major [K, P, n, Wp] int32 layout the scale tier keeps resident. No
FASTA, no host genome and no host-to-device copy of the O(n * sketch)
tensor.

Model (three-level hierarchy of b-bit MinHash bins):

    root bins  --(strain mask, keep prob q_sk)-->  strain centroid bins
    centroid   --(genome mask, keep prob m_ik)-->  genome bins

Each genome's bin is either inherited from its strain centroid (mask bit
1) or replaced with independent random bits (mask bit 0); masks act per
bin, i.e. the same bit position across all ``bbits`` planes. Two genomes
of one strain then agree on a bin iff both masks kept it (prob
m_ik * m_jk) or by chance (2^-bbits, the random-collision floor the
distance correction removes), so the corrected Jaccard at k is

    within strain:   j(k) ~ m_ik * m_jk
    between strains: j(k) ~ m_ik * m_jk * q_sk * q_tk

With m_ik = sqrt(pi_i) * exp(-k * d_i / 2) and
q_sk = sqrt(rho_s) * exp(-k * D_s / 2), the fitted k-mer curve recovers

    core distance      (d_i + d_j) / 2              within
                       (d_i + d_j + D_s + D_t) / 2  between
    accessory distance 1 - sqrt(pi_i pi_j)              within
                       1 - sqrt(pi_i pi_j rho_s rho_t)  between

Bernoulli bits with arbitrary probability come from the binary-expansion
trick: for p = 0.b15 b14 ... b0 (16 bits), fold uniform random words r_b
LSB-first with ``acc = b ? (r | acc) : (r & acc)``; each step maps
P -> b/2 + P/2, so the final per-bit probability is exactly p rounded to
the nearest 1/65536. (8-bit floor quantisation is NOT enough: its up-to-
0.4% always-downward, k-dependent sawtooth error on the keep probability
m_ik biases the fitted k-mer slope, i.e. the recovered core distance, by
several 1e-3, swamping the planted within-strain divergences.)

What differs from the reference, and why:
  - the bits come from one seeded ``torch.Generator`` on the device, drawn
    in a fixed order (jax.random's keys cannot be reproduced); the host
    draws (strain sizes, divergences, retentions, lengths, frequencies)
    are the reference's ``np.random.default_rng(seed)`` calls in its
    order, so ``strain``, ``d``, ``pi``, ``lengths`` and ``freqs`` equal
    its own;
  - words are int32 and only bitwise ops touch them (torch has no general
    uint32 arithmetic); the pad words past w32 are cleared with an AND.
    The reference multiplies by its 0xFFFFFFFF mask instead, which in
    uint32 arithmetic negates every valid word, so its bins carry a
    borrow from their lower neighbours and follow the model above only
    approximately;
  - the genome chunks are a host loop, not a ``lax.scan``.
"""

import math

import numpy as np
import torch

from . import _device
from .ops.distances import plane_geometry

_PROB_BITS = 16


def _random_words(gen, shape):
    """int32 words of independent fair bits."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device=gen.device, dtype=torch.int32)


def _bernoulli_words(gen, prob, shape):
    """int32 words of independent Bernoulli(prob) bits.

    prob: float32 tensor broadcastable to shape[:-1] (per-word
    probability, applied to all 32 bits of that word), rounded to the
    nearest 1/65536.
    """
    quant = torch.round(prob.clamp(0.0, 1.0) * (1 << _PROB_BITS)).to(
        torch.int32).clamp(max=(1 << _PROB_BITS) - 1)
    acc = torch.zeros(shape, dtype=torch.int32, device=gen.device)
    for b in range(_PROB_BITS):
        r = _random_words(gen, shape)
        bit = ((quant >> b) & 1) == 1
        acc = torch.where(bit[..., None], r | acc, r & acc)
    return acc


def _keep_probs(pi, div, klist):
    """m[..., K] = sqrt(pi) * exp(-k * div / 2), float32."""
    return (torch.sqrt(pi)[..., None]
            * torch.exp(-klist[None, :] * div[..., None] / 2.0))


def _masked_planes(gen, parents, keep_prob, valid):
    """Derive child plane sets from parents by per-bin keep masks.

    parents: int32 [c, K, P, Wp]; keep_prob [c, K]; valid: int32 [Wp],
    all ones on the w32 useful words, zero on the pads. Returns the same
    shape with pad words zeroed.
    """
    c, K, _, wp = parents.shape
    mask = _bernoulli_words(gen, keep_prob, (c, K, wp))[:, :, None, :]
    rand = _random_words(gen, tuple(parents.shape))
    return ((parents & mask) | (rand & ~mask)) & valid


def _f32(values, device):
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


class SyntheticSketches:
    """Device-resident synthetic sketch population.

    Attributes: planes (int32 PLANE-MAJOR [K, P, n, Wp] on the device, the
    scale pipeline's native layout), lengths (int32 [n]), freqs
    (float32 [n, 4]), strain (int [n] host), plus the per-genome core
    divergences d and accessory retentions pi for oracle checks. planes_gm
    materialises the genome-major [n, K, P, Wp] twin (host-path oracles;
    small n only, it is a full copy).
    """

    def __init__(self, planes, lengths, freqs, strain, d, pi, klist,
                 sketchsize64, bbits):
        self.planes = planes
        self.lengths = lengths
        self.freqs = freqs
        self.strain = strain
        self.d = d
        self.pi = pi
        self.klist = klist
        self.sketchsize64 = sketchsize64
        self.bbits = bbits

    @property
    def planes_gm(self):
        """Genome-major [n, K, P, Wp] copy (test oracles; small n)."""
        return self.planes.permute(2, 0, 1, 3).contiguous()


def synthetic_population_device(
        n, klist, sketchsize64, bbits, n_strains=20, seed=0, chunk=1024,
        core_div=(0.0008, 0.004), strain_div=(0.008, 0.02),
        accessory_within=(0.88, 0.97), accessory_strain=(0.70, 0.88),
        tree_depth=4, strain_alpha=1.5, device=None):
    """Generate n genomes' sketches on the device, chunked.

    core_div / strain_div: per-genome and per-strain half-divergence
    ranges (uniform); accessory_*: bin-retention (pi / rho) ranges.

    Within each strain, genomes hang off a balanced binary coalescent of
    ``tree_depth`` levels: every internal node re-masks its parent's bins
    with a per-node divergence step (drawn from core_div / tree_depth, so
    root-to-leaf totals stay in the core_div range), and each genome adds
    a personal step below its leaf. Pairwise within-strain distances are
    then a *tree metric*, continuous and pair-structured, instead of the
    rank-one d_i + d_j form a flat generator yields: rank-one distances
    make the within blob a threshold graph (a quasi-clique at any cut),
    which degenerates PopPUNK's transitivity * (1 - density) refine score
    into preferring the tightest boundary.

    The bits are drawn from a ``torch.Generator`` on ``device`` (None:
    ``_device.resolve``'s choice) seeded with ``seed``.
    """
    dev = _device.resolve(device)
    w32, wp, _ = plane_geometry(sketchsize64, bbits)
    K = len(klist)
    kl = _f32(klist, dev)
    valid = torch.where(torch.arange(wp, device=dev) < w32, -1, 0).to(
        torch.int32)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    # strain composition: Dirichlet sizes, per-strain divergence from
    # root. strain_alpha controls size imbalance: 1.5 gives mild spread;
    # ~0.3 gives the heavy-tailed strain-size skew of real surveillance
    # populations (a few dominant clones + a long tail of singletons)
    sizes = rng.dirichlet(np.full(n_strains, strain_alpha)) * n
    sizes = np.maximum(sizes.astype(np.int64), 1)
    while sizes.sum() != n:  # fix rounding drift
        sizes[int(rng.integers(n_strains))] += 1 if sizes.sum() < n else -1
        sizes = np.maximum(sizes, 1)
    strain = np.repeat(np.arange(n_strains), sizes)

    D_s = rng.uniform(*strain_div, n_strains)
    rho_s = rng.uniform(*accessory_strain, n_strains)

    # root + strain centroids (small: [S, K, P, Wp])
    root = _random_words(gen, (1, K, bbits, wp)) & valid
    q_sk = _keep_probs(_f32(rho_s, dev), _f32(D_s, dev), kl)
    centroids = _masked_planes(gen, root.expand(n_strains, -1, -1, -1),
                               q_sk, valid)

    # within-strain coalescent: split every strain centroid tree_depth
    # times (all strains share each level's [S * 2^l, K, P, Wp] draw)
    L = max(0, int(tree_depth))
    lvl_d = rng.uniform(*core_div, (L, n_strains << L)) / max(L, 1)
    lvl_pi = rng.uniform(*accessory_within,
                         (L, n_strains << L)) ** (1.0 / (L + 1))
    nodes = centroids
    for lev in range(L):
        m = nodes.shape[0] * 2
        keep = _keep_probs(_f32(lvl_pi[lev, :m], dev),
                           _f32(lvl_d[lev, :m], dev), kl)
        nodes = _masked_planes(gen, nodes.repeat_interleave(2, dim=0), keep,
                               valid)

    # genome -> leaf assignment (balanced contiguous within each strain)
    leaves_per = 1 << L
    rank = np.concatenate([np.arange(c) for c in sizes])
    leaf_in_strain = rank * leaves_per // np.maximum(sizes[strain], 1)
    leaf = strain * leaves_per + leaf_in_strain

    # expected root-to-leaf divergence/retention per genome (oracle aid):
    # sum of its path steps + the personal step below the leaf
    d_path = np.zeros(n_strains << L)
    pi_path = np.ones(n_strains << L)
    for lev in range(L):
        node_of_leaf = np.arange(n_strains << L) >> (L - 1 - lev)
        d_path += lvl_d[lev, node_of_leaf]
        pi_path *= lvl_pi[lev, node_of_leaf]
    d_pers = rng.uniform(*core_div, n) / max(L, 1)
    pi_pers = rng.uniform(*accessory_within, n) ** (1.0 / (L + 1))
    d_i = d_path[leaf] + d_pers
    pi_i = pi_path[leaf] * pi_pers

    m_ik = _keep_probs(_f32(pi_pers, dev), _f32(d_pers, dev), kl)
    if n % chunk:
        chunk = math.gcd(n, chunk)
    leaf_d = torch.as_tensor(leaf, device=dev)
    planes = torch.empty((K, bbits, n, wp), dtype=torch.int32, device=dev)
    for start in range(0, n, chunk):
        rows = slice(start, start + chunk)
        out = _masked_planes(gen, nodes[leaf_d[rows]], m_ik[rows], valid)
        planes[:, :, rows] = out.permute(1, 2, 0, 3)

    lengths = torch.as_tensor(
        rng.integers(1_800_000, 2_400_000, n).astype(np.int32), device=dev)
    freqs = _f32(rng.dirichlet([20.0, 15.0, 15.0, 20.0], n), dev)
    return SyntheticSketches(planes, lengths, freqs, strain,
                             d_i, pi_i, tuple(int(k) for k in klist),
                             sketchsize64, bbits)
