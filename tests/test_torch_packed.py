"""The port's packed-lane bin-match counts (poppunk_tpu_torch/ops/
match_counts.py: _lane_groups, pack_lane_groups, match_counts_packed_torch,
match_counts_packed, match_counts_device) against the JAX package's
packed kernel (match_counts_pallas_packed, in interpret mode), its plain
oracle match_counts_xla and its dispatcher.

Tolerance: exact. Layouts and counts are integers; any difference is a
fault. The packed CUDA kernel has no CPU mode: its cases carry the
``cuda`` marker and skip without a card (run them on the H100 with
``python -m pytest tests/test_torch_packed.py -m cuda``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from poppunk_tpu.ops import pallas_jaccard as pj
from poppunk_tpu.ops.distances import match_counts_xla
from poppunk_tpu_torch.ops import distances as tdist
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


SMALL = (16, 5)  # ss64, bbits: the JAX kernel tests' geometry
ODD = (15, 5)  # w32 = 30: a 16-byte chunk straddles two k slots
PRODUCTION = (156, 14)  # sketch size 9984, 14 planes
SHORT = (2, 5)  # w32 4: fewer 8-word stages per group than the ring holds

# the JAX package's packed cases (test_sketch.py:256-257) plus an odd ss64
PACKED_CASES = [(3, 5, 3, None, SMALL), (64, 128, 3, 2, SMALL),
                (65, 129, 5, 2, SMALL), (9, 17, 6, 4, SMALL),
                (7, 11, 4, None, ODD), (10, 13, 5, 3, ODD)]


def random_planes(n, ss64, bbits, K, rng):
    w32, wp, _ = plane_geometry(ss64, bbits)
    planes = np.zeros((n, K, bbits, wp), dtype=np.uint32)
    planes[..., :w32] = rng.integers(0, 2**32, (n, K, bbits, w32),
                                     dtype=np.uint32)
    return planes


def pair(nq, nr, K, geometry, seed):
    rng = np.random.default_rng(seed)
    ss64, bbits = geometry
    pq = random_planes(nq, ss64, bbits, K, rng)
    pr = random_planes(nr, ss64, bbits, K, rng)
    # planted agreement so counts span more than the random-match floor
    m = min(nq, nr)
    pr[:m, :, :, : pq.shape[-1] // 3] = pq[:m, :, :, : pq.shape[-1] // 3]
    w32, _, pad_bits = plane_geometry(ss64, bbits)
    return pq, pr, w32, pad_bits


def packed(planes, w32, g, device=None):
    """PackedPlanes of numpy planes with group width g (None: auto)."""
    _, K, P, _ = planes.shape
    if g is None:
        g, lanes, kg = mc._lane_groups(w32, K, bbits=P)
    else:
        lanes = -(-g * w32 // 128) * 128
        kg = -(-K // g)
    bits = mc.pack_lane_groups(planes_to_tensor(planes, device), w32, g,
                               lanes, kg)
    return mc.PackedPlanes(bits, w32, g, K)


@pytest.mark.parametrize("w32,K,bbits", [(312, 5, 14), (312, 6, 14),
                                         (32, 3, 5), (32, 6, 5), (30, 4, 5),
                                         (30, 5, 5), (8, 9, 3)])
def test_lane_groups_equal_jax(w32, K, bbits):
    assert mc._lane_groups(w32, K, bbits=bbits) == \
        pj._lane_groups(w32, K, bbits=bbits)


def test_lane_groups_rejects_oversize_geometry_like_jax():
    with pytest.raises(ValueError, match="VMEM"):
        pj._lane_groups(704, 6, bbits=14, tq=64, tr=256)
    with pytest.raises(ValueError, match="VMEM"):
        mc._lane_groups(704, 6, bbits=14, tq=64, tr=256)


@pytest.mark.parametrize("plane_major", [False, True])
@pytest.mark.parametrize("K,g,geometry", [(5, 2, SMALL), (6, 4, SMALL),
                                          (5, 3, ODD), (5, 2, PRODUCTION)])
def test_pack_lane_groups_equal_jax(K, g, geometry, plane_major):
    pq, _, w32, _ = pair(6, 1, K, geometry, K * 10 + g)
    lanes = -(-g * w32 // 128) * 128
    kg = -(-K // g)
    src = pq.transpose(1, 2, 0, 3) if plane_major else pq
    want = np.asarray(pj.pack_lane_groups(src, w32, g, lanes, kg,
                                          plane_major))
    got = mc.pack_lane_groups(planes_to_tensor(src), w32, g, lanes, kg,
                              plane_major)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("nq,nr,K,g,geometry", PACKED_CASES)
def test_packed_plain_equals_pallas_interpret_and_xla(nq, nr, K, g,
                                                      geometry):
    pq, pr, w32, pad_bits = pair(nq, nr, K, geometry, nq * 1000 + nr + K)
    got = mc.match_counts_packed_torch(packed(pq, w32, g),
                                       packed(pr, w32, g)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        pj.match_counts_pallas_packed(pq, pr, w32, g=g, tq=8, tr=16,
                                      interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(match_counts_xla(pq, pr, pad_bits)))


@pytest.mark.parametrize("K", [5, 6])
def test_packed_plain_production_geometry(K):
    """ss64 156, 14 planes: G 2, L 640 (KG 3 either way; K 5 leaves a
    zero slot in the last group)."""
    pq, pr, w32, pad_bits = pair(5, 7, K, PRODUCTION, K)
    assert mc._lane_groups(w32, K, bbits=14) == (2, 640, 3)
    q, r = (mc.pack(planes_to_tensor(p), pad_bits) for p in (pq, pr))
    np.testing.assert_array_equal(
        mc.match_counts_packed_torch(q, r).numpy(),
        np.asarray(match_counts_xla(pq, pr, pad_bits)))


def test_row_slices_are_views_with_the_same_counts():
    pq, pr, w32, pad_bits = pair(9, 40, 5, ODD, 17)
    q = mc.pack(planes_to_tensor(pq), pad_bits)
    r = mc.pack(planes_to_tensor(pr), pad_bits)
    part = r.rows(11, 30)
    assert part.bits.data_ptr() == r.bits[:, :, 11].data_ptr()
    assert not part.bits.is_contiguous()
    np.testing.assert_array_equal(
        mc.match_counts_packed_torch(q, part).numpy(),
        np.asarray(match_counts_xla(pq, pr[11:30], pad_bits)))


def test_dispatcher_routes_on_choice(monkeypatch):
    """match_counts_device honours KERNEL_CHOICE (read at import from
    POPPUNK_TPU_KERNEL), derives w32 from pad_bits, and passes operands
    that are packed already through without repacking
    (as test_sketch.py::test_kernel_dispatcher_routes_on_choice pins for
    the JAX dispatcher)."""
    calls = []
    monkeypatch.setattr(mc, "match_counts",
                        lambda *a: calls.append(("std", a)))
    monkeypatch.setattr(mc, "match_counts_packed",
                        lambda *a: calls.append(("packed", a)))
    q = torch.zeros((2, 3, 5, 128), dtype=torch.int32)
    monkeypatch.setattr(mc, "KERNEL_CHOICE", "standard")
    mc.match_counts_device(q, q, 64)
    monkeypatch.setattr(mc, "KERNEL_CHOICE", "packed")
    mc.match_counts_device(q, q, 64)
    assert [c[0] for c in calls] == ["std", "packed"]
    pq, pr = calls[1][1]
    assert pq.w32 == pr.w32 == 128 - 64 // 32
    ready = mc.pack(q, 64)
    mc.match_counts_device(ready, q, 64)
    assert calls[2][1][0] is ready


@pytest.mark.parametrize("value,choice", [("PACKED", "packed"),
                                          ("standard", "standard"),
                                          ("bogus", None)])
def test_kernel_choice_read_once_at_import(value, choice):
    script = ("import poppunk_tpu_torch.ops.match_counts as mc; "
              "print(mc.KERNEL_CHOICE)")
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, POPPUNK_TPU_KERNEL=value),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if choice is None:
        assert proc.returncode != 0
        assert "expected 'standard' or 'packed'" in proc.stderr
    else:
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == choice


def test_cpu_tensors_take_the_plain_packed_version(monkeypatch):
    pq, pr, w32, pad_bits = pair(4, 6, 3, SMALL, 9)

    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(mc._build, "load", no_build)
    monkeypatch.setattr(mc, "KERNEL_CHOICE", "packed")
    before = mc.PACKED_LAUNCHES
    got = mc.match_counts_device(planes_to_tensor(pq), planes_to_tensor(pr),
                                 pad_bits)
    assert mc.PACKED_LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(match_counts_xla(pq, pr, pad_bits)))


def test_packed_wrapper_rejects_bad_inputs():
    pq, pr, w32, pad_bits = pair(2, 3, 3, SMALL, 4)
    q = mc.pack(planes_to_tensor(pq), pad_bits)
    r = mc.pack(planes_to_tensor(pr), pad_bits)
    with pytest.raises(TypeError, match="int32"):
        mc.match_counts_packed(q._replace(bits=q.bits.to(torch.int64)), r)
    with pytest.raises(ValueError, match="differ"):
        mc.match_counts_packed(q, r._replace(w32=w32 - 2))
    with pytest.raises(ValueError, match="does not hold"):
        mc.match_counts_packed(q._replace(k=7), r._replace(k=7))
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        mc.match_counts_packed(q._replace(bits=q.bits.to("meta")),
                               r._replace(bits=r.bits.to("meta")))


@pytest.mark.parametrize("self_mode", [True, False])
def test_distance_passes_equal_under_both_choices(self_mode, monkeypatch):
    """The packed route packs each operand set once per call and slices
    row views per query chunk; distances equal the standard route's bit
    for bit (chunk 8 forces several chunks and ragged tails)."""
    ss64, bbits, K = 15, 5, 4
    rng = np.random.default_rng(5)
    planes = random_planes(21, ss64, bbits, K, rng)
    planes[10:] = planes[:11]
    planes[10:, :, :, :6] ^= rng.integers(0, 2**32, (11, K, bbits, 6),
                                          dtype=np.uint32)
    lengths = rng.integers(50_000, 90_000, 21).astype(np.int32)
    freqs = rng.dirichlet([5, 4, 4, 5], 21).astype(np.float32)
    klist = (13, 17, 21, 25)

    def run():
        if self_mode:
            return tdist.condensed_self_block(planes, lengths, freqs, klist,
                                              ss64, bbits, chunk=8)
        return tdist.pairwise_block(planes[:9], planes[9:], lengths[:9],
                                    lengths[9:], freqs[:9], freqs[9:],
                                    klist, ss64, bbits, chunk=4)

    monkeypatch.setattr(mc, "KERNEL_CHOICE", "standard")
    standard = run()
    monkeypatch.setattr(mc, "KERNEL_CHOICE", "packed")
    packs, real_pack = [], mc.pack
    monkeypatch.setattr(mc, "pack",
                        lambda *a: packs.append(1) or real_pack(*a))
    np.testing.assert_array_equal(run(), standard)
    assert len(packs) == (1 if self_mode else 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a card (it has no CPU mode)")
    from poppunk_tpu_torch import _device

    _device.set_full_precision()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nr,K,g,geometry", PACKED_CASES + [
    (257, 1031, 5, None, PRODUCTION), (130, 200, 6, None, PRODUCTION),
    # 64 x 64 block tiles: a single pair, and ragged edges either way
    (1, 1, 3, None, SMALL), (127, 129, 5, 2, SMALL),
    (129, 65, 6, None, PRODUCTION), (9, 17, 3, None, SHORT),
    (9, 17, 5, 2, SHORT)])
def test_packed_kernel_equals_plain_and_standard(cuda_device, nq, nr, K, g,
                                                 geometry):
    pq, pr, w32, pad_bits = pair(nq, nr, K, geometry, nq + nr + K)
    q = packed(pq, w32, g, cuda_device)
    r = packed(pr, w32, g, cuda_device)
    before = mc.PACKED_LAUNCHES
    got = mc.match_counts_packed(q, r)
    torch.cuda.synchronize()
    assert mc.PACKED_LAUNCHES == before + 1
    assert torch.equal(got, mc.match_counts_packed_torch(q, r))
    std = mc.match_counts(planes_to_tensor(pq, cuda_device),
                          planes_to_tensor(pr, cuda_device), pad_bits)
    assert torch.equal(got, std)
    # a row slice of the packed references: strided, no copy
    part = r.rows(3, nr - 1)
    assert torch.equal(mc.match_counts_packed(q, part), got[:, 3:nr - 1])


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [ODD, PRODUCTION])
def test_packed_kernel_on_row_views_with_offsets(cuda_device, geometry):
    """Both operands as row views of packed tensors, starting past row 0:
    a non-zero base offset in the tensor map, rows past the view's end
    unread."""
    pq, pr, w32, pad_bits = pair(70, 130, 5, geometry, 23)
    q = mc.pack(planes_to_tensor(pq, cuda_device), pad_bits)
    r = mc.pack(planes_to_tensor(pr, cuda_device), pad_bits)
    got = mc.match_counts_packed(q.rows(5, 69), r.rows(3, 129))
    torch.cuda.synchronize()
    std = mc.match_counts(planes_to_tensor(pq[5:69], cuda_device),
                          planes_to_tensor(pr[3:129], cuda_device), pad_bits)
    assert torch.equal(got, std)
    assert torch.equal(got, mc.match_counts_packed_torch(q.rows(5, 69),
                                                         r.rows(3, 129)))
