"""The port's bin-match counts (poppunk_tpu_torch/ops/match_counts.py)
against the JAX package's kernel and oracles.

Tolerance: exact. Counts are integers; any difference is a fault.
The CUDA kernel has no CPU mode: its cases carry the ``cuda`` marker and
skip without a card (run them on the H100 with
``python -m pytest tests/test_torch_match_counts.py -m cuda``).
"""

import numpy as np
import pytest
import torch

from poppunk_tpu.ops.distances import match_counts_xla
from poppunk_tpu.ops.distances import plane_geometry as jax_plane_geometry
from poppunk_tpu.ops.jaccard_np import match_counts_block_np
from poppunk_tpu.ops.pallas_jaccard import match_counts_pallas
from poppunk_tpu_torch.ops import match_counts as mc
from poppunk_tpu_torch.ops.distances import plane_geometry, planes_to_tensor

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    this file's tests ask for it, as a CPU-only host must."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


SMALL = (16, 5, 3)  # ss64, bbits, K — the JAX kernel tests' geometry
PRODUCTION = (156, 14, 5)  # sketch size 9984, 14 planes, k = 13..29 step 4
SHORT = (2, 5, 3)  # w32 4: fewer 8-word stages per k than the ring holds
ODD = (15, 5, 4)  # w32 30: the last stage of each k is partial


def random_planes(n, ss64, bbits, K, rng):
    w32, wp, _ = plane_geometry(ss64, bbits)
    planes = np.zeros((n, K, bbits, wp), dtype=np.uint32)
    planes[..., :w32] = rng.integers(0, 2**32, (n, K, bbits, w32),
                                     dtype=np.uint32)
    return planes


def pair(nq, nr, geometry, seed):
    rng = np.random.default_rng(seed)
    ss64, bbits, K = geometry
    pq = random_planes(nq, ss64, bbits, K, rng)
    pr = random_planes(nr, ss64, bbits, K, rng)
    # planted agreement so counts span more than the random-match floor
    m = min(nq, nr)
    pr[:m, :, :, : pq.shape[-1] // 3] = pq[:m, :, :, : pq.shape[-1] // 3]
    return pq, pr, plane_geometry(ss64, bbits)[2]


def to_uint64_plane_major(planes, k, ss64):
    """[n, K, P, Wp] uint32 -> uint64 [n, P, ss64] at k (jaccard_np layout)."""
    u = planes[:, k, :, :2 * ss64].astype(np.uint64)
    return u[..., 0::2] | (u[..., 1::2] << np.uint64(32))


def port_counts(pq, pr, pad_bits):
    return mc.match_counts_torch(planes_to_tensor(pq), planes_to_tensor(pr),
                                 pad_bits).numpy()


@pytest.mark.parametrize("nq,nr", [(3, 5), (64, 128), (65, 129)])
def test_plain_equals_xla_oracle(nq, nr):
    pq, pr, pad_bits = pair(nq, nr, SMALL, nq * 1000 + nr)
    want = np.asarray(match_counts_xla(pq, pr, pad_bits))
    np.testing.assert_array_equal(port_counts(pq, pr, pad_bits), want)


@pytest.mark.parametrize("nq,nr", [(3, 5), (64, 128), (65, 129)])
def test_plain_equals_pallas_interpret(nq, nr):
    pq, pr, pad_bits = pair(nq, nr, SMALL, nq * 7 + nr)
    want = np.asarray(match_counts_pallas(pq, pr, pad_bits, tq=8, tr=16,
                                          interpret=True))
    np.testing.assert_array_equal(port_counts(pq, pr, pad_bits), want)


@pytest.mark.parametrize("nq,nr", [(3, 5), (64, 128), (65, 129)])
def test_plain_equals_numpy_oracle(nq, nr):
    ss64, _, K = SMALL
    pq, pr, pad_bits = pair(nq, nr, SMALL, nq * 13 + nr)
    got = port_counts(pq, pr, pad_bits)
    for k in range(K):
        want = match_counts_block_np(to_uint64_plane_major(pq, k, ss64),
                                     to_uint64_plane_major(pr, k, ss64))
        np.testing.assert_array_equal(got[..., k], want)


def test_plain_production_geometry():
    """ss64 156, 14 planes, K 5: Wp 384 with 72 zero pad words."""
    pq, pr, pad_bits = pair(5, 7, PRODUCTION, 3)
    assert jax_plane_geometry(156, 14)[2] == pad_bits == 72 * 32
    got = port_counts(pq, pr, pad_bits)
    np.testing.assert_array_equal(
        got, np.asarray(match_counts_xla(pq, pr, pad_bits)))
    np.testing.assert_array_equal(
        got, np.asarray(match_counts_pallas(pq, pr, pad_bits, tq=8, tr=8,
                                            interpret=True)))


def test_popcount32_matches_bitwise_count():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    words[:6] = [0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x55555555]
    got = mc.popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(words))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    pq, pr, pad_bits = pair(4, 6, SMALL, 9)

    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(mc._build, "load", no_build)
    before = mc.LAUNCHES
    got = mc.match_counts(planes_to_tensor(pq), planes_to_tensor(pr),
                          pad_bits)
    assert mc.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), port_counts(pq, pr, pad_bits))


def test_wrapper_rejects_bad_inputs():
    pq, pr, pad_bits = pair(2, 3, SMALL, 4)
    q, r = planes_to_tensor(pq), planes_to_tensor(pr)
    with pytest.raises(TypeError, match="int32"):
        mc.match_counts(q.to(torch.int64), r, pad_bits)
    with pytest.raises(ValueError, match="differ"):
        mc.match_counts(q, r[:, :2].contiguous(), pad_bits)
    with pytest.raises(ValueError, match="pad_bits"):
        mc.match_counts(q, r, pad_bits + 1)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        mc.match_counts(q.to("meta"), r.to("meta"), pad_bits)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a card (it has no CPU mode)")
    from poppunk_tpu_torch import _device

    _device.set_full_precision()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nr,geometry", [
    (3, 5, SMALL), (64, 128, SMALL), (65, 129, SMALL),
    (257, 1031, PRODUCTION),
    # 64 x 64 block tiles: a single pair, and ragged edges either way
    (1, 1, SMALL), (127, 129, SMALL), (129, 65, PRODUCTION),
    (9, 17, SHORT), (65, 129, ODD)])
def test_kernel_equals_plain(cuda_device, nq, nr, geometry):
    pq, pr, pad_bits = pair(nq, nr, geometry, nq + nr)
    q = planes_to_tensor(pq, cuda_device)
    r = planes_to_tensor(pr, cuda_device)
    before = mc.LAUNCHES
    got = mc.match_counts(q, r, pad_bits)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == before + 1
    want = mc.match_counts_torch(q, r, pad_bits)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_rejects_wrong_dtype(cuda_device):
    pq, pr, pad_bits = pair(2, 3, SMALL, 5)
    q = torch.from_numpy(pq.astype(np.int64)).to(cuda_device)
    with pytest.raises(TypeError, match="int32"):
        mc.match_counts(q, planes_to_tensor(pr, cuda_device), pad_bits)


@pytest.mark.cuda
def test_kernel_on_row_slices(cuda_device):
    """Query chunks are row slices of one planes tensor (ops/distances.py):
    views with a non-zero base offset, read through the tensor map as
    they are."""
    pq, pr, pad_bits = pair(70, 130, ODD, 11)
    q = planes_to_tensor(pq, cuda_device)
    r = planes_to_tensor(pr, cuda_device)
    whole = mc.match_counts(q, r, pad_bits)
    got = mc.match_counts(q[5:69], r[3:], pad_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, whole[5:69, 3:])
    assert torch.equal(got, mc.match_counts_torch(q[5:69], r[3:], pad_bits))
