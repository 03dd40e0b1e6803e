"""The port's device mesh and sharded distance engine against the JAX
package's, on the CPU.

The JAX package runs its mesh on the 8 virtual CPU devices of
tests/conftest.py; the port's counterpart of a virtual device is a mesh
whose device list repeats one device, get_mesh(devices=[cpu] * 8). The
same seeded numpy planes (tests/test_parallel.py's) go through both
sharded blocks and the port's single-device block.

Tolerances: the port's sharded block equals its single-device block bit
for bit (every tile's arithmetic is the same whatever its shape,
ops/distances._dot4), and so do the fused classes. Against the JAX
package's mesh, the classes exactly and the distances within
tests/test_parallel.py's own mesh tolerance, atol 1e-4: on its random
planes the two packages' single-device blocks already differ by up to
3.1e-5 at a near-zero accessory distance (the fit's 1 - e^slope), past
the port's rtol 1e-5 / atol 2e-5 for planted populations
(tests/test_torch_distances.py, which the sketch API case keeps).
"""

import numpy as np
import pytest
import torch

import poppunk_tpu.ops.distances as jd
import poppunk_tpu.parallel as jpar
import poppunk_tpu_torch.ops.distances as td
import poppunk_tpu_torch.parallel.mesh as tmesh
from poppunk_tpu.ops.fused_assign import model_post_spec as jax_post_spec
from poppunk_tpu_torch.ops import match_counts as mc
from poppunk_tpu_torch.ops.fused_assign import model_post_spec
from poppunk_tpu_torch.parallel import (get_mesh, mesh_shape_for,
                                        sharded_pairwise_block,
                                        sharded_query_dists,
                                        sharded_self_dists)
from test_fused_assign import bgmm_model, refine_model
from test_parallel import BBITS, KLIST, SS64, synth

torch.set_num_threads(2)

CPU = torch.device("cpu")
DIST_TOL = dict(rtol=1e-5, atol=2e-5)
MESH_TOL = dict(atol=1e-4)  # tests/test_parallel.py's


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


def virtual(n_q=None, n=8):
    return get_mesh(devices=[CPU] * n, n_q=n_q)


@pytest.fixture(params=["standard", "packed"])
def kernel(request, monkeypatch):
    """Both kernel choices: each shard's tile runs _dist_chunk, so the
    packed choice packs each reference shard."""
    monkeypatch.setattr(mc, "KERNEL_CHOICE", request.param)
    return request.param


@pytest.mark.parametrize("n_q", [1, 2, 4])
def test_sharded_matches_single_chip(n_q, kernel):
    pq, lq, fq = synth(10, 1)
    pr, lr, fr = synth(23, 2)
    got = sharded_pairwise_block(virtual(n_q), pq, pr, lq, lr, fq, fr,
                                 KLIST, SS64, BBITS)
    one = td.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS)
    want = jpar.sharded_pairwise_block(jpar.get_mesh(8, n_q=n_q), pq, pr,
                                       lq, lr, fq, fr, KLIST, SS64, BBITS,
                                       use_pallas=False)
    assert got.shape == one.shape == want.shape == (10, 23, 2)
    np.testing.assert_array_equal(got, one)
    np.testing.assert_allclose(got, want, **MESH_TOL)


@pytest.mark.parametrize("q_chunk", [1, 4])
def test_sharded_query_chunking(q_chunk):
    pq, lq, fq = synth(30, 3)
    pr, lr, fr = synth(17, 4)
    got = sharded_pairwise_block(virtual(2), pq, pr, lq, lr, fq, fr, KLIST,
                                 SS64, BBITS, q_chunk=q_chunk)
    np.testing.assert_array_equal(
        got, td.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS))
    want = jpar.sharded_pairwise_block(jpar.get_mesh(8, n_q=2), pq, pr, lq,
                                       lr, fq, fr, KLIST, SS64, BBITS,
                                       use_pallas=False, q_chunk=q_chunk)
    np.testing.assert_allclose(got, want, **MESH_TOL)


def test_sharded_jaccards():
    pq, lq, fq = synth(9, 5)
    pr, lr, fr = synth(14, 6)
    got = sharded_pairwise_block(virtual(2), pq, pr, lq, lr, fq, fr, KLIST,
                                 SS64, BBITS, jaccard=True)
    assert got.shape == (9, 14, len(KLIST))
    np.testing.assert_array_equal(
        got, td.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS,
                               jaccard=True))


def test_sharded_sketch_api(population_dir, tmp_path):
    """Sharded self/query distances from real sketches equal the
    single-device query_db output, and the JAX package's."""
    from poppunk_tpu.io.hdf5db import construct_database
    from poppunk_tpu_torch.io.hdf5db import read_sketches

    _, rfile = population_dir
    db = str(tmp_path / "pardb")
    klist = [15, 19, 23]
    construct_database(rfile, klist, 16, db)
    sketches = read_sketches(db)
    mesh = virtual(2)

    got_self = sharded_self_dists(sketches, klist, mesh)
    np.testing.assert_array_equal(
        got_self, td.query_db(sketches, None, klist, self_mode=True))
    np.testing.assert_allclose(
        got_self, jd.query_db(sketches, None, klist, self_mode=True,
                              use_pallas=False), **DIST_TOL)

    refs, queries = sketches[:9], sketches[9:]
    got_qr = sharded_query_dists(refs, queries, klist, mesh)
    np.testing.assert_array_equal(got_qr, td.query_db(refs, queries, klist))
    np.testing.assert_allclose(got_qr, jd.query_db(refs, queries, klist,
                                                   use_pallas=False),
                               **DIST_TOL)


@pytest.mark.parametrize("kind", ["boundary", "bgmm"])
def test_fused_sharded_matches_single(kind, kernel):
    model = refine_model() if kind == "boundary" else bgmm_model()
    pq, lq, fq = synth(10, 7)
    pr, lr, fr = synth(23, 8)
    d_mesh, a_mesh = sharded_pairwise_block(
        virtual(2), pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS,
        post_spec=model_post_spec(model))
    d_one, a_one = td.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64,
                                     BBITS, post_spec=model_post_spec(model))
    np.testing.assert_array_equal(d_mesh, d_one)
    np.testing.assert_array_equal(a_mesh, a_one)
    d_jax, a_jax = jpar.sharded_pairwise_block(
        jpar.get_mesh(8, n_q=2), pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS,
        use_pallas=False, post_spec=jax_post_spec(model))
    np.testing.assert_allclose(d_mesh, d_jax, **MESH_TOL)
    np.testing.assert_array_equal(a_mesh, np.asarray(a_jax))


def test_pairwise_block_takes_a_mesh():
    """use_mesh=True with a mesh shards; use_mesh=False and the CPU's
    automatic rule do not."""
    pq, lq, fq = synth(6, 9)
    pr, lr, fr = synth(11, 10)
    one = td.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS,
                            use_mesh=False)
    got = td.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS,
                            use_mesh=True, mesh=virtual(4))
    np.testing.assert_array_equal(got, one)
    assert td._auto_mesh(CPU, 1 << 20) is None


@pytest.mark.parametrize("post", [False, True])
def test_condensed_self_block_on_a_mesh(monkeypatch, post):
    """The condensed pass with the automatic mesh forced on: the same rows
    and classes as the single route, and the reference shards placed on
    the mesh once for the whole pass, not once a chunk."""
    import poppunk_tpu_torch.parallel.dists as tdists

    planes, lengths, freqs = synth(37, 13)
    spec = model_post_spec(bgmm_model()) if post else None
    kw = dict(chunk=8, post_spec=spec)
    want = td.condensed_self_block(planes, lengths, freqs, KLIST, SS64,
                                   BBITS, **kw)
    placed = []
    real = tdists.ShardedReferences

    def counted(*args):
        placed.append(1)
        return real(*args)

    monkeypatch.setattr(tdists, "ShardedReferences", counted)
    monkeypatch.setattr(td, "_auto_mesh", lambda device, n_pairs: virtual(2))
    got = td.condensed_self_block(planes, lengths, freqs, KLIST, SS64, BBITS,
                                  **kw)
    assert len(placed) == 1
    for a, b in zip(got if post else [got], want if post else [want]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_dev,pairs,shape", [
    (4, 1 << 16, {"q": 2, "r": 2}),
    (2, 1 << 16, {"q": 1, "r": 2}),
    (6, 1 << 20, {"q": 2, "r": 3}),
    (3, 1 << 16, {"q": 1, "r": 3}),
    (1, 1 << 20, None),
    (4, (1 << 16) - 1, None)])
def test_auto_mesh_rule(monkeypatch, n_dev, pairs, shape):
    """The reference's rule (ops/distances.py:242-253) for a computing
    card: more than one device in the default mesh and at least
    _SHARD_MIN_PAIRS pairs; n_q 2 when the count is even and above 2."""
    monkeypatch.setattr(tmesh, "visible_devices", lambda: [CPU] * n_dev)
    mesh = td._auto_mesh(torch.device("cuda", 0), pairs)
    assert (None if mesh is None else mesh.shape) == shape
    assert td._SHARD_MIN_PAIRS == jd._SHARD_MIN_PAIRS


@pytest.mark.parametrize("n,n_q,want", [(8, None, (1, 8)), (8, 2, (2, 4)),
                                        (8, 4, (4, 2)), (6, 3, (3, 2)),
                                        (1, None, (1, 1))])
def test_mesh_shapes_equal_the_jax_packages(n, n_q, want):
    from poppunk_tpu.parallel.mesh import mesh_shape_for as jax_shape_for

    assert mesh_shape_for(n, n_q) == jax_shape_for(n, n_q) == want
    mesh = virtual(n_q, n)
    assert (mesh.shape["q"], mesh.shape["r"]) == want
    assert mesh.devices.shape == want and mesh.size == n
    assert mesh.flat() == [CPU] * n
    assert [(qi, ri) for qi, ri, _ in mesh.tiles()] == [
        (qi, ri) for qi in range(want[0]) for ri in range(want[1])]
    assert (mesh.ranks == 0).all()


def test_get_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="must divide"):
        virtual(3)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        get_mesh(2)
    # the default mesh under POPPUNK_TPU_TORCH_DEVICE=cpu: the CPU
    assert get_mesh().flat() == [CPU]
    monkeypatch.setattr(tmesh, "visible_devices", lambda: [CPU] * 4)
    assert get_mesh(2, n_q=2).shape == {"q": 2, "r": 1}


def test_get_mesh_refuses_without_cuda(monkeypatch):
    """Without CUDA, without POPPUNK_TPU_TORCH_DEVICE=cpu and without
    explicit devices, the default mesh raises, as _device.resolve does;
    explicit devices are taken as they are."""
    monkeypatch.delenv("POPPUNK_TPU_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        get_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        tmesh.default_device_count()
    assert virtual(2).size == 8


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_choice", ["standard", "packed"])
def test_sharded_block_on_the_card(monkeypatch, kernel_choice):
    """A virtual mesh of 4 shards on cuda:0, shape (2, 2): the sharded
    block launches the kernel of the choice on every tile and equals the
    card's single-device block, the fused BGMM classes included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(mc, "KERNEL_CHOICE", kernel_choice)
    card = torch.device("cuda", 0)
    mesh = get_mesh(devices=[card] * 4, n_q=2)
    pq, lq, fq = synth(100, 11)
    pr, lr, fr = synth(300, 12)
    spec = model_post_spec(bgmm_model())
    counter = "LAUNCHES" if kernel_choice == "standard" else \
        "PACKED_LAUNCHES"
    before = getattr(mc, counter)
    d_mesh, a_mesh = td.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64,
                                       BBITS, use_mesh=True, mesh=mesh,
                                       post_spec=spec)
    assert getattr(mc, counter) - before == 4  # one tile per shard
    d_one, a_one = td.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64,
                                     BBITS, post_spec=spec, device=card,
                                     use_mesh=False)
    np.testing.assert_allclose(d_mesh, d_one, **DIST_TOL)
    np.testing.assert_array_equal(a_mesh, a_one)
