"""The port's synthetic population generator (poppunk_tpu_torch/synth.py)
held to its model, on the CPU.

The bits come from a torch.Generator and cannot equal jax.random's, so
the device draws are held to the model the generator states: the host
draws (strain sizes, divergences, retentions, lengths, frequencies) equal
the JAX package's for the same seed; the planes' pad words are zero; the
binary-expansion Bernoulli bits keep each bit at the 16-bit quantised
probability (within 4 sigma, tight enough to tell it from an 8-bit
quantisation); the b-bit-corrected Jaccards and the fitted core /
accessory distances recover the planted divergences and retentions; and
the scale pipeline on the port's own draw recovers the planted strains.

Oracle tolerances: the genomes of one strain share their centroid's
realised bins, and the strains share the root's, so per-k Jaccard means
carry the centroids' sampling noise, sqrt(q (1 - q) / nbins) ~ 0.5% of a
keep probability q at 8192 bins per k. Means are held within 2% (within
strains, where a pair's path meets only at the centroid) and 3% (between
strains, through two centroids and the root); the fitted core and
accessory means within 5% (the k-mer fit turns a 0.5% per-k wobble into
~2% on the slope across 6 k).
"""

import numpy as np
import pytest
import torch

from poppunk_tpu.synth import synthetic_population_device as jax_synth
from poppunk_tpu_torch import synth
from poppunk_tpu_torch.ops.distances import condensed_self_block
from poppunk_tpu_torch.scale import run_scale_pipeline
from test_torch_scale_buffered import PIPELINE

torch.set_num_threads(2)

KLIST = (13, 15, 17, 19, 21, 23)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        m.delenv("POPPUNK_TPU_BOOTSTRAP", raising=False)
        yield


DRAWS = {
    "defaults": dict(n=96, klist=(13, 17, 21), sketchsize64=3, bbits=5,
                     n_strains=7, seed=4, chunk=32),
    "skewed": dict(n=90, klist=(15, 19), sketchsize64=2, bbits=3,
                   n_strains=5, seed=11, chunk=64, tree_depth=2,
                   strain_alpha=0.3, core_div=(0.001, 0.003)),
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_host_draws_equal_the_jax_package(name):
    kw = DRAWS[name]
    got = synth.synthetic_population_device(**kw, device=CPU)
    want = jax_synth(**kw)
    np.testing.assert_array_equal(got.strain, want.strain)
    np.testing.assert_array_equal(got.d, want.d)
    np.testing.assert_array_equal(got.pi, want.pi)
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_array_equal(got.freqs.numpy(), np.asarray(want.freqs))
    assert got.planes.shape == want.planes.shape
    assert got.planes.dtype == torch.int32
    assert (got.klist, got.sketchsize64, got.bbits) == (
        want.klist, want.sketchsize64, want.bbits)


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_planes_are_zero_past_w32_and_follow_the_seed(name):
    from poppunk_tpu_torch.ops.distances import plane_geometry

    kw = DRAWS[name]
    pop = synth.synthetic_population_device(**kw, device=CPU)
    w32, wp, _ = plane_geometry(kw["sketchsize64"], kw["bbits"])
    assert wp > w32
    assert not pop.planes[..., w32:].any()
    assert pop.planes[..., :w32].any()
    gm = pop.planes_gm
    assert gm.shape == (kw["n"], len(kw["klist"]), kw["bbits"], wp)
    assert torch.equal(gm[5], pop.planes[:, :, 5])
    again = synth.synthetic_population_device(**kw, device=CPU)
    assert torch.equal(again.planes, pop.planes)
    other = synth.synthetic_population_device(**{**kw, "seed": 99},
                                              device=CPU)
    assert not torch.equal(other.planes, pop.planes)


def test_bernoulli_bits_keep_the_16_bit_probability():
    """Each probability is set 0.99/256 past a multiple of 1/256, where an
    8-bit floor quantisation would miss by ~0.0039 (~8 sigma here)."""
    probs = (np.arange(1, 8) * 31 + 0.99) / 256
    gen = torch.Generator().manual_seed(2)
    words = 8192
    p = torch.tensor(probs, dtype=torch.float32)[:, None].expand(-1, 4)
    out = synth._bernoulli_words(gen, p, (len(probs), 4, words))
    bits = torch.stack([(out >> b) & 1 for b in range(32)])
    rate = bits.double().mean(dim=(0, 2, 3)).numpy()
    quant = np.round(probs.astype(np.float32) * 65536) / 65536
    sigma = np.sqrt(quant * (1 - quant) / (4 * words * 32))
    assert (np.abs(rate - quant) < 4 * sigma).all(), (rate, quant)
    assert (np.abs(rate - np.floor(probs * 256) / 256) > 6 * sigma).all()
    # the ends: never and (but for 1/65536) always
    ends = synth._bernoulli_words(gen, torch.tensor([0.0, 1.0]), (2, 4096))
    assert not ends[0].any()
    assert ((ends[1] >> torch.arange(32)[:, None]) & 1).double().mean() > \
        1 - 1e-3


def test_fair_words_are_fair():
    gen = torch.Generator().manual_seed(5)
    w = synth._random_words(gen, (1 << 16,))
    rate = torch.stack([(w >> b) & 1 for b in range(32)]).double().mean(1)
    assert (rate - 0.5).abs().max() < 4 * 0.5 / 256


@pytest.fixture(scope="module")
def planted():
    """A population at 8192 bins per k, its distances without the
    random-match correction (the model has none), and the replayed
    per-strain draws D_s, rho_s."""
    n, S, seed, ss64 = 192, 6, 9, 128
    pop = synth.synthetic_population_device(n, KLIST, ss64, 8, n_strains=S,
                                            seed=seed, chunk=64, device=CPU)
    args = (pop.planes_gm.numpy().view(np.uint32), pop.lengths.numpy(),
            pop.freqs.numpy(), KLIST, ss64, 8)
    X = condensed_self_block(*args, random_correct=False)
    J = condensed_self_block(*args, random_correct=False, jaccard=True)
    # the generator's host stream up to the strain draws
    rng = np.random.default_rng(seed)
    sizes = np.maximum((rng.dirichlet(np.full(S, 1.5)) * n).astype(np.int64),
                       1)
    while sizes.sum() != n:
        sizes[int(rng.integers(S))] += 1 if sizes.sum() < n else -1
        sizes = np.maximum(sizes, 1)
    D_s = rng.uniform(0.008, 0.02, S)
    rho_s = rng.uniform(0.70, 0.88, S)
    return pop, X, J, sizes, D_s, rho_s


def test_distances_recover_the_planted_divergences(planted):
    pop, X, J, sizes, D_s, rho_s = planted
    n = len(pop.strain)
    i, j = np.triu_indices(n, 1)
    s, d, pi = pop.strain, pop.d, pop.pi
    # within a strain, the pairs whose paths meet at the centroid (the
    # first split of the 4-level coalescent): j(k) = m_i(k) m_j(k)
    rank = np.concatenate([np.arange(c) for c in sizes])
    half = (rank * 16 // sizes[s]) >> 3
    within = (s[i] == s[j]) & (half[i] != half[j])
    between = s[i] != s[j]
    k = np.asarray(KLIST, np.float64)[None, :]
    cases = {
        "within": (within, d[i] + d[j], pi[i] * pi[j], 0.02),
        "between": (between, d[i] + d[j] + D_s[s[i]] + D_s[s[j]],
                    pi[i] * pi[j] * rho_s[s[i]] * rho_s[s[j]], 0.03),
    }
    for name, (m, div, ret, tol) in cases.items():
        assert m.sum() > 1000, name
        model = np.sqrt(ret[m])[:, None] * np.exp(-k * div[m][:, None] / 2)
        np.testing.assert_allclose(J[m].mean(axis=0), model.mean(axis=0),
                                   rtol=tol, err_msg=name)
        core = 1 - np.exp(-div[m] / 2)
        acc = 1 - np.sqrt(ret[m])
        np.testing.assert_allclose(X[m, 0].mean(), core.mean(), rtol=0.05,
                                   err_msg=name)
        np.testing.assert_allclose(X[m, 1].mean(), acc.mean(), rtol=0.05,
                                   err_msg=name)
    # the two blobs PopPUNK models stand apart
    assert X[between, 0].min() > X[within, 0].max()


@pytest.mark.parametrize("streaming", [False, True])
def test_pipeline_recovers_the_planted_strains(streaming):
    log = []
    out = run_scale_pipeline(streaming=streaming, log=log.append, **PIPELINE)
    assert out["ari"] > 0.99
    assert out["n_clusters"] == 10
    assert out["streaming"] is streaming
    assert out["pairs_per_s"] > 0 and 1 <= out["n_lineages"] <= 256
    route = "edges" if streaming else "device"
    assert any(f"via {route} sweep" in m for m in log)
