"""Synthetic bacterial populations as b-bit bin sketches, drawn on the card.

The benchmark's own generator: a frozen rewrite of the strain-tree idea of
``poppunk_tpu_torch/synth.py`` in plain PyTorch, importing nothing of the
program. Each sketch is the genome-major bit-plane layout the program
takes: int32 words ``[n, K, P, Wp]``, bin ``32 w + b`` of plane ``p`` at
bit ``b`` of word ``w``, the words from ``w32`` on left zero.

Model (three levels of b-bit bins, one mask bit per bin, so a bin is kept
or redrawn in all ``P`` planes together):

    root bins  --(strain keep q_s(k))-->  strain centroid
    centroid   --(``depth`` levels of a balanced binary tree)-->  leaf
    leaf       --(the genome's own step)-->  genome

A step of half-divergence ``d`` and retention ``pi`` keeps each bin with
probability ``sqrt(pi) exp(-k d / 2)`` and draws the rest afresh, so two
genomes meet at k-mer length k with a Jaccard of about the product of the
keep probabilities on the path between them: core distance the summed
half-divergences, accessory distance one less the root of the retentions.

Real sketches also share bins by chance: two unrelated genomes meet at
short k-mer lengths as often as random sequences of their lengths and base
composition would, which the distance's random-match correction removes. A
redrawn bin therefore takes, with probability sqrt(r(k)), the value of one
chance sketch shared by the population, so that two redrawn bins agree
with probability r(k) at the population's mean length and composition.

A keep bit of probability p comes from p's 16-bit binary expansion: fold
fair random words from the lowest bit, ``b ? r | acc : r & acc``, which
lands on p rounded to the nearest 1/65536.

The host draws (strain sizes, divergences, retentions, leaves, lengths,
base frequencies) come from ``numpy.random.default_rng(seed)``; the bits
from one ``torch.Generator`` on ``device`` seeded with ``seed``, in large
calls and a fixed order. The same seed gives the same population.
"""

import numpy as np
import torch

PROB_BITS = 16


def plane_geometry(sketchsize64):
    """(w32, Wp): useful int32 words per plane row and the row length the
    program lays out (a multiple of 128 words)."""
    w32 = 2 * sketchsize64
    return w32, ((w32 + 127) // 128) * 128


def _words(gen, shape):
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device=gen.device, dtype=torch.int32)


def _keep_words(gen, prob, shape):
    """int32 words whose bits are independent Bernoulli(prob): ``prob``
    broadcasts to ``shape[:-1]``."""
    quant = torch.round(prob.clamp(0.0, 1.0) * (1 << PROB_BITS)).to(
        torch.int32).clamp(max=(1 << PROB_BITS) - 1)
    acc = torch.zeros(shape, dtype=torch.int32, device=gen.device)
    for b in range(PROB_BITS):
        r = _words(gen, shape)
        bit = ((quant >> b) & 1).bool()[..., None]
        acc = torch.where(bit, r | acc, r & acc)
    return acc


def _keep_prob(pi, d, klist):
    """[m, K] float32 keep probabilities of m steps."""
    return (torch.sqrt(pi)[:, None]
            * torch.exp(-klist[None, :] * d[:, None] / 2.0))


def _step(gen, parents, keep, chance, valid):
    """Children of ``parents`` [m, K, P, Wp]: each bin kept with the
    probability ``keep`` [m, K], redrawn otherwise; a redrawn bin takes
    the chance sketch's value (``chance``: ([1, K, P, Wp] words, [K]
    probability)) or a fresh one."""
    m, K, _, wp = parents.shape
    mask = _keep_words(gen, keep, (m, K, wp))[:, :, None, :]
    words, prob = chance
    common = _keep_words(gen, prob.expand(m, K), (m, K, wp))[:, :, None, :]
    fresh = (words & common) | (_words(gen, tuple(parents.shape)) & ~common)
    return ((parents & mask) | (fresh & ~mask)) & valid


def chance_jaccard(pop, klist):
    """[K] the Jaccard two random genomes of the population's mean length
    and base composition share by chance (both strands)."""
    f = np.asarray(pop["base_composition"], np.float64)
    f = f / f.sum()
    n = np.mean(pop["genome_length"]) - np.asarray(klist, np.float64) + 1
    p = (f @ f) ** np.asarray(klist) + (f @ f[::-1]) ** np.asarray(klist)
    inter = n * n * p
    return inter / (2 * n - inter)


def strain_sizes(rng, n, n_strains, alpha):
    """Genomes per strain: a Dirichlet(alpha) share of n, each at least 1,
    summing to n (alpha ~0.3 gives the few large clones and long tail of
    surveillance collections)."""
    sizes = np.maximum((rng.dirichlet(np.full(n_strains, alpha)) * n)
                       .astype(np.int64), 1)
    while sizes.sum() > n:
        big = np.flatnonzero(sizes > 1)
        sizes[big[int(rng.integers(len(big)))]] -= 1
    while sizes.sum() < n:
        sizes[int(rng.integers(n_strains))] += 1
    return sizes


def draw(strain, n_strains, pop, klist, sketchsize64, bbits, seed, device,
         chunk=2048):
    """Sketches of genomes whose strains are ``strain`` (int [n], values
    below ``n_strains``) under the population parameters ``pop`` (a
    configuration's ``population`` group). Returns (planes int32 [n, K, P,
    Wp] on ``device``, lengths int32 [n] numpy, freqs float32 [n, 4]
    numpy)."""
    strain = np.asarray(strain, np.int64)
    n = strain.shape[0]
    w32, wp = plane_geometry(sketchsize64)
    K, P = len(klist), bbits
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    kl = torch.as_tensor(np.asarray(klist, np.float32), device=device)
    valid = torch.where(torch.arange(wp, device=device) < w32, -1, 0).to(
        torch.int32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    depth = int(pop["tree_depth"])
    # chance k-mer matches: two redrawn bins agree with probability r(k)
    chance = (_words(gen, (1, K, P, wp)) & valid,
              f32(np.sqrt(chance_jaccard(pop, klist))))
    # strain centroids from one root
    d_s = rng.uniform(*pop["strain_half_divergence"], n_strains)
    rho_s = rng.uniform(*pop["strain_retention"], n_strains)
    root = _words(gen, (1, K, P, wp)) & valid
    nodes = _step(gen, root.expand(n_strains, -1, -1, -1).contiguous(),
                  _keep_prob(f32(rho_s), f32(d_s), kl), chance, valid)
    # the tree inside each strain: the genome's core_half_divergence and
    # genome_retention spread over depth + 1 steps
    steps = depth + 1
    lo, hi = pop["core_half_divergence"]
    rlo, rhi = pop["genome_retention"]
    for _ in range(depth):
        m = nodes.shape[0] * 2
        d = rng.uniform(lo / steps, hi / steps, m)
        pi = rng.uniform(rlo, rhi, m) ** (1.0 / steps)
        nodes = _step(gen, nodes.repeat_interleave(2, dim=0),
                      _keep_prob(f32(pi), f32(d), kl), chance, valid)
    leaf = strain * (1 << depth) + rng.integers(0, 1 << depth, n)
    d_g = rng.uniform(lo / steps, hi / steps, n)
    pi_g = rng.uniform(rlo, rhi, n) ** (1.0 / steps)
    keep = _keep_prob(f32(pi_g), f32(d_g), kl)
    leaf_d = torch.as_tensor(leaf, device=device)
    planes = torch.empty((n, K, P, wp), dtype=torch.int32, device=device)
    for start in range(0, n, chunk):
        rows = slice(start, min(start + chunk, n))
        planes[rows] = _step(gen, nodes[leaf_d[rows]], keep[rows], chance,
                             valid)
    del nodes
    lengths = rng.integers(*pop["genome_length"], n).astype(np.int32)
    freqs = rng.dirichlet(np.asarray(pop["base_composition"], np.float64)
                          * pop["base_concentration"], n).astype(np.float32)
    return planes, lengths, freqs
