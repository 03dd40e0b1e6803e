"""The population generator: the same for one seed, different for
another."""

import numpy as np
import torch

from benchmark import population

POP = {"strains": 4, "strain_skew_alpha": 0.3, "tree_depth": 2,
       "strain_half_divergence": [0.008, 0.016],
       "strain_retention": [0.5, 0.8],
       "core_half_divergence": [0.0005, 0.003],
       "genome_retention": [0.8, 0.95],
       "genome_length": [2000000, 2200000],
       "base_composition": [0.3, 0.2, 0.2, 0.3],
       "base_concentration": 4000}


def _draw(seed):
    strain = np.repeat(np.arange(4), 6)
    return population.draw(strain, 4, POP, (13, 16, 19), 4, 3, seed,
                           torch.device("cpu"))


def test_population_is_a_function_of_the_seed():
    a, b, c = _draw(2 ** 31 + 5), _draw(2 ** 31 + 5), _draw(2 ** 31 + 6)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert not torch.equal(a[0], c[0])
    assert not np.array_equal(a[1], c[1])


def test_population_layout():
    planes, lengths, freqs = _draw(3)
    w32, wp = population.plane_geometry(4)
    assert planes.shape == (24, 3, 3, wp) and planes.dtype == torch.int32
    assert not planes[..., w32:].any()
    assert lengths.min() >= 2000000 and lengths.max() < 2200000
    assert np.allclose(freqs.sum(1), 1, atol=1e-5)


def test_strain_sizes_sum_and_floor():
    rng = np.random.default_rng(1)
    sizes = population.strain_sizes(rng, 1000, 300, 0.3)
    assert sizes.sum() == 1000 and sizes.min() >= 1

