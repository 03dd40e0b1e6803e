"""The port's batched Brandes (poppunk_tpu_torch/ops/brandes_device.py)
against the JAX package's and the port's host oracle, on the CPU.

Every case of tests/test_brandes_device.py runs on the same numpy inputs
through poppunk_tpu.ops.brandes_device (JAX on the CPU) and the port, and
the port's betweenness is held to both and to the port's host oracle
(network/summary.brandes_betweenness, its numpy path) within rtol 1e-5,
the JAX tests' own tolerance. pack_components' arrays equal the JAX
package's exactly wherever its max_comp keeps every component; with
fewer, the port keeps the largest (the reference keeps the first labels,
ADVICE.md round 5).
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from poppunk_tpu.ops.brandes_device import \
    brandes_batched_device as jax_brandes
from poppunk_tpu.ops.brandes_device import \
    pack_components as jax_pack_components
from poppunk_tpu_torch.ops.brandes_device import (brandes_batched_device,
                                                  pack_components)

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def port_brandes(*args, **kwargs):
    return brandes_batched_device(*args, device=CPU, **kwargs).numpy()


def host_oracle(A, sources):
    """The port's numpy Brandes (its native engine turned off)."""
    import poppunk_tpu_torch.network.incremental as incremental
    import poppunk_tpu_torch.network.summary as summary

    real = incremental.brandes_native
    try:
        incremental.brandes_native = lambda *a, **k: None
        return summary.brandes_betweenness(scipy.sparse.csr_matrix(A),
                                           np.asarray(sources))
    finally:
        incremental.brandes_native = real


def random_adj(n, p, rng):
    A = rng.random((n, n)) < p
    A = np.triu(A, 1)
    return (A | A.T).astype(np.float32)


def assert_both(Ap, src, w=None, exact=True):
    """The port's [C, m] betweenness, held to the JAX package's."""
    got = port_brandes(Ap, src, w, exact=exact)
    want = np.asarray(jax_brandes(Ap, src, w, exact=exact))
    np.testing.assert_allclose(got, want, **TOL)
    return got


@pytest.mark.parametrize("n,p", [(24, 0.15), (48, 0.08), (64, 0.3)])
def test_single_component_all_sources(n, p):
    rng = np.random.default_rng(n)
    A = random_adj(n, p, rng)
    Ap = np.zeros((1, 64, 64), np.float32)
    Ap[0, :n, :n] = A
    src = np.full((1, 64), -1, np.int32)
    src[0, :n] = np.arange(n)
    got = assert_both(Ap, src)[0, :n]
    np.testing.assert_allclose(got, host_oracle(A, np.arange(n)), **TOL)


def test_sampled_sources_with_weights():
    rng = np.random.default_rng(3)
    n = 40
    A = random_adj(n, 0.12, rng)
    sources = rng.choice(n, size=11, replace=False)
    scale = n / 11
    w = np.full((1, 11), scale, np.float32)
    got = assert_both(A[None], sources[None].astype(np.int32), w)[0]
    np.testing.assert_allclose(got, host_oracle(A, sources) * scale, **TOL)


def ringed_components(sizes, rng):
    """Edges (i, j) of random components of ``sizes`` with a ring each
    (connected), and the component label of every vertex."""
    offs = np.cumsum([0] + list(sizes))
    i_l, j_l = [], []
    for k, s in enumerate(sizes):
        A = random_adj(s, 0.5, rng)
        for v in range(s):
            A[v, (v + 1) % s] = A[(v + 1) % s, v] = 1
        a, b = np.nonzero(np.triu(A, 1))
        i_l.append(a + offs[k])
        j_l.append(b + offs[k])
    labels = np.concatenate([np.full(s, k) for k, s in enumerate(sizes)])
    return np.concatenate(i_l), np.concatenate(j_l), labels, offs


def test_multi_component_pack():
    """Three components of different sizes + dust that must be dropped
    (size <= 3); the packing equals the JAX package's exactly."""
    rng = np.random.default_rng(7)
    sizes = [30, 17, 9, 3, 2]
    i, j, labels, offs = ringed_components(sizes, rng)
    adj, local_of, comps = pack_components(i, j, labels, pad_to=32)
    j_adj, j_local_of, j_comps = jax_pack_components(i, j, labels,
                                                     pad_to=32)
    np.testing.assert_array_equal(adj, j_adj)
    np.testing.assert_array_equal(local_of, j_local_of)
    assert len(comps) == len(j_comps)
    for a, b in zip(comps, j_comps):
        np.testing.assert_array_equal(a, b)
    assert adj.shape[0] == 3 and adj.shape[1] == 32
    assert all(local_of[offs[3]:] == -1)
    S = max(len(v) for v in comps)
    src = np.full((3, S), -1, np.int32)
    for c, verts in enumerate(comps):
        src[c, :len(verts)] = np.arange(len(verts))
    got = assert_both(adj, src)
    for c, verts in enumerate(comps):
        s = len(verts)
        mask = (i < offs[c + 1]) & (i >= offs[c])
        A = np.zeros((s, s), np.float32)
        A[i[mask] - offs[c], j[mask] - offs[c]] = 1
        A = A + A.T
        np.testing.assert_allclose(got[c, :s], host_oracle(A, np.arange(s)),
                                   **TOL)
        assert np.all(got[c, s:] == 0)


def test_disconnected_and_empty():
    # two cliques in one component slot, padded apart: unreachable pairs
    # contribute nothing
    A = np.zeros((1, 8, 8), np.float32)
    for a in range(3):
        for b in range(3):
            if a != b:
                A[0, a, b] = 1
                A[0, 4 + a, 4 + b] = 1
    got = assert_both(A, np.arange(8, dtype=np.int32)[None])
    np.testing.assert_allclose(got, 0.0, atol=1e-6)  # cliques: bc 0
    np.testing.assert_allclose(
        got[0], host_oracle(A[0], np.arange(8)), **TOL)
    # no sources at all
    got = assert_both(A, np.full((1, 4), -1, np.int32))
    np.testing.assert_allclose(got, 0.0, atol=1e-6)


def test_path_graph_exact():
    """A path graph's interior vertex k of n gets 2 k (n - 1 - k)
    (double counting)."""
    n = 9
    A = np.zeros((1, 16, 16), np.float32)
    for v in range(n - 1):
        A[0, v, v + 1] = A[0, v + 1, v] = 1
    src = np.full((1, 16), -1, np.int32)
    src[0, :n] = np.arange(n)
    got = assert_both(A, src)[0, :n]
    want = np.array([2.0 * k * (n - 1 - k) for k in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, host_oracle(A[0, :n, :n],
                                                np.arange(n)), **TOL)


def test_inexact_equals_exact_on_the_cpu():
    """exact=False asks for the card's reduced-precision product; the CPU
    has none, so the result is exact=True's."""
    rng = np.random.default_rng(5)
    A = random_adj(48, 0.1, rng)[None]
    src = np.arange(48, dtype=np.int32)[None]
    np.testing.assert_array_equal(port_brandes(A, src, exact=False),
                                  port_brandes(A, src, exact=True))


# --------------------------------------------------------------------------
# pack_components(max_comp=...): the largest components, in label order


@pytest.mark.parametrize("max_comp", [None, 4, 9])
def test_max_comp_keeping_every_component_equals_the_jax_package(max_comp):
    rng = np.random.default_rng(13)
    i, j, labels, _ = ringed_components([6, 25, 4, 2, 11], rng)
    got = pack_components(i, j, labels, max_comp=max_comp, pad_to=16)
    want = jax_pack_components(i, j, labels, max_comp=max_comp, pad_to=16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert [list(c) for c in got[2]] == [list(c) for c in want[2]]


def test_max_comp_keeps_the_largest_components():
    """Sizes 6, 25, 4, 11, 11 (label order): max_comp 3 keeps 25 and both
    11s (the tie at 11 resolved to the lower label when max_comp 2), in
    label order; the reference's first three labels would keep the 4."""
    rng = np.random.default_rng(17)
    i, j, labels, offs = ringed_components([6, 25, 4, 11, 11], rng)
    _, local_of, comps = pack_components(i, j, labels, max_comp=3)
    assert [len(c) for c in comps] == [25, 11, 11]
    np.testing.assert_array_equal(comps[0], np.arange(offs[1], offs[2]))
    assert (local_of[offs[0]:offs[1]] == -1).all()
    assert (local_of[offs[2]:offs[3]] == -1).all()
    _, _, comps = pack_components(i, j, labels, max_comp=2)
    np.testing.assert_array_equal(comps[1], np.arange(offs[3], offs[4]))
    _, _, j_comps = jax_pack_components(i, j, labels, max_comp=3)
    assert [len(c) for c in j_comps] == [6, 25, 4]


@pytest.mark.cuda
def test_brandes_on_the_card():
    """On the card, exact=True equals the CPU's result within rtol 1e-5
    and the host oracle; exact=False runs the TF32 products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(2)
    A = random_adj(200, 0.05, rng)
    Ap = np.zeros((2, 256, 256), np.float32)
    Ap[0, :200, :200] = A
    Ap[1, :200, :200] = A
    src = np.tile(np.arange(50, dtype=np.int32), (2, 1))
    got = brandes_batched_device(Ap, src).cpu().numpy()
    np.testing.assert_allclose(got, port_brandes(Ap, src), **TOL)
    np.testing.assert_allclose(got[0, :200], host_oracle(A, np.arange(50)),
                               **TOL)
    fast = brandes_batched_device(Ap, src, exact=False).cpu().numpy()
    assert np.isfinite(fast).all()
