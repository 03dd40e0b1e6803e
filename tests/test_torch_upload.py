"""The planes' upload (poppunk_tpu_torch/ops/distances.py::planes_to_tensor):
an array past one slab goes to a card through two reused page-locked
slabs (_slab_copy), anything else in one ``.to(device)``. The slab walk
runs here on the CPU, with pageable buffers into a CPU destination; the
``cuda`` cases hold the card's route to the host bits."""

import numpy as np
import pytest
import torch

from poppunk_tpu_torch import profiling
from poppunk_tpu_torch.ops import distances as td

SLAB = 4096  # bytes: small slabs, so a few kilobytes take several


def _words(shape, seed, high=False):
    """uint32 planes of ``shape``; with ``high`` every word is >= 2**31."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    return words | np.uint32(0x80000000) if high else words


# name: (the host array, its bytes over SLAB)
CASES = {
    "under-one-slab": (lambda: _words((1, 2, 2, 128), 1), 0.5),
    "exactly-3-slabs": (lambda: _words((6, 2, 2, 128), 2), 3.0),
    "ragged-last-slab": (lambda: _words((7, 1, 3, 128), 3), 2.625),
    "zero-genomes": (lambda: _words((0, 2, 2, 128), 4), 0.0),
    "non-contiguous": (lambda: _words((2, 6, 2, 128), 5).transpose(
        1, 2, 0, 3)[1:5], 2.0),
    "words-past-2**31": (lambda: _words((5, 2, 2, 128), 6, high=True), 2.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_copy_is_the_host_bits(case):
    make, slabs = CASES[case]
    planes = make()
    assert planes.nbytes == slabs * SLAB
    want = torch.from_numpy(np.ascontiguousarray(planes).view(np.int32))
    # every byte starts as its complement, so one left unwritten shows
    dst = ~want.clone()
    td._slab_copy(planes, dst, SLAB)
    assert dst.shape == want.shape and dst.dtype == torch.int32
    assert dst.numpy().tobytes() == want.numpy().tobytes()
    # the slabs cover every byte once, in order
    ranges = td._slab_ranges(planes.nbytes, SLAB)
    assert len(ranges) == -(-planes.nbytes // SLAB)
    ends = [0] + [b for _, b in ranges]
    assert [a for a, _ in ranges] == ends[:-1] and ends[-1] == planes.nbytes
    assert all(0 < b - a <= SLAB for a, b in ranges)
    # the CPU keeps the direct path: same bits, nothing staged
    got, staged = td._upload(planes, torch.device("cpu"))
    assert staged == 0
    assert got.numpy().tobytes() == want.numpy().tobytes()


# --------------------------------------------------------------------------
# on the card (skipped on a host without CUDA)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_three_and_a_half_slabs_land_bit_equal_on_the_card(cuda_device):
    """At the real slab size: 3.5 slabs take the slabs, and the card holds
    the host's bits; an array of one slab takes the direct path."""
    n = 7 * td.UPLOAD_SLAB // (2 * 2 * 2 * 128 * 4)
    planes = _words((n, 2, 2, 128), 7, high=True)
    planes[::3] &= np.uint32(0x7FFFFFFF)
    assert planes.nbytes == 3.5 * td.UPLOAD_SLAB
    got, staged = td._upload(planes, cuda_device)
    assert staged == planes.nbytes
    assert got.device == cuda_device and got.dtype == torch.int32
    assert got.shape == planes.shape
    assert got.cpu().numpy().tobytes() == planes.tobytes()
    assert td.planes_to_tensor(planes, cuda_device).cpu().numpy().tobytes() \
        == planes.tobytes()
    one = planes[:n * 2 // 7]
    assert one.nbytes == td.UPLOAD_SLAB
    got, staged = td._upload(one, cuda_device)
    assert staged == 0 and got.cpu().numpy().tobytes() == one.tobytes()


@pytest.mark.cuda
def test_dists_upload_counts_the_staged_planes_on_the_card(cuda_device,
                                                           monkeypatch):
    """condensed_self_block from host planes past one (small) slab: the
    upload's span counts the planes as staged, its bytes as before, and
    the distances equal those from the direct upload."""
    n, ss64, bbits, klist = 40, 2, 4, (13, 17, 21)
    w32, wp, _ = td.plane_geometry(ss64, bbits)
    planes = np.zeros((n, len(klist), bbits, wp), np.uint32)
    planes[..., :w32] = _words((n, len(klist), bbits, w32), 8)
    rng = np.random.default_rng(8)
    lengths = rng.integers(1_900_000, 2_100_000, n).astype(np.int32)
    freqs = rng.dirichlet(np.full(4, 50.0), n).astype(np.float32)

    def run():
        return td.condensed_self_block(planes, lengths, freqs, klist, ss64,
                                       bbits, chunk=16, device=cuda_device)

    direct = run()
    monkeypatch.setattr(td, "UPLOAD_SLAB", 10_000)
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.clear()
    staged = run()
    (up,) = [s for s in profiling.spans() if s.name == "dists.upload"]
    profiling.clear()
    assert up.counts["staged"] == planes.nbytes
    assert up.counts["bytes"] == planes.nbytes + lengths.nbytes + freqs.nbytes
    assert staged.tobytes() == direct.tobytes()
