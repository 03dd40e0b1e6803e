"""The two device sweeps sum without widening a whole block.

``ops/device_sweep.sweep_scores_device`` sums sum(A * (A @ A)) in float64
one _SQUARE_ROWS row block at a time, and ``ops/sparse_sweep``'s triangle
popcount sums take each row in int32 before the int64 total: torch widens
a tensor with a full copy before it sums it in a wider type, so neither
may hand it the whole [n, n] product or a whole popcount block.

On the CPU, ``torch.profiler`` (profile_memory) records each op's bytes:
the widening copies (``aten::_to_copy``) must stay within one row block,
and the results must equal the existing oracles (the JAX package and the
host scorer, as tests/test_torch_refine.py and
tests/test_torch_sparse_sweep.py hold them) and the single-block result
bit for bit. On the card, ``torch.cuda.max_memory_allocated`` holds the
dense sweep at phase G's n to two float32 squares plus one float64 row
block (and shows that the whole-square float64 sum it replaced widens the
whole product there too), and the sparse sweep's step to
ops/sparse_sweep.sweep_peak_bytes' scoring terms.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from poppunk_tpu.network.incremental import grow_network_scores
from poppunk_tpu.ops import device_sweep as jsweep
from poppunk_tpu_torch.ops import device_sweep as tsweep
from poppunk_tpu_torch.ops import sparse_sweep as tss

import test_torch_sparse_sweep as sparse_oracles

torch.set_num_threads(2)

CPU = torch.device("cpu")
# the device sweep against the JAX package's float32 sweep and the host
# sweep: tests/test_torch_refine.py's tolerance
SWEEP_ATOL = 1e-6
# the card's allocator rounds each block up; what the peak may hold beyond
# the named buffers (index tensors, degrees, the caching allocator's 2 MB
# granularity)
CARD_MARGIN = 64 * 2**20


def random_sweep(n, n_offsets, n_edges, seed):
    """Unique edges i < j with ascending first offsets."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, n_edges)
    j = rng.integers(0, n, n_edges)
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    keep = lo < hi
    key = np.unique(lo[keep] * n + hi[keep])
    idx = np.sort(rng.integers(0, n_offsets, key.shape[0]))
    return key // n, key % n, idx


def widening_copies(fn):
    """(result, bytes of every aten::_to_copy fn makes, largest single
    allocation) on the CPU."""
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = fn()
    events = prof.events()
    copies = [e.cpu_memory_usage for e in events
              if e.name == "aten::_to_copy"]
    largest = max(e.self_cpu_memory_usage for e in events)
    return out, copies, largest


def test_dense_sweep_sums_row_blocks_without_a_square_copy(monkeypatch):
    n, n_offsets, rows = 512, 6, 64
    i, j, idx = random_sweep(n, n_offsets, 12000, 0)
    one_block = tsweep.sweep_scores_device(n, i, j, idx, n_offsets, CPU)
    monkeypatch.setattr(tsweep, "_SQUARE_ROWS", rows)
    got, copies, largest = widening_copies(
        lambda: tsweep.sweep_scores_device(n, i, j, idx, n_offsets, CPU))
    # the widened copies are one float64 row block each, and nothing is
    # larger than a float32 square (A, its product)
    assert copies and max(copies) <= 8 * rows * n
    assert largest <= 4 * n * n
    # exact integers summed in float64: any block order gives the same bits
    np.testing.assert_array_equal(got, one_block)
    np.testing.assert_allclose(
        got, jsweep.sweep_scores_device(n, i, j, idx, n_offsets),
        atol=SWEEP_ATOL)
    np.testing.assert_allclose(
        got, grow_network_scores(n, i, j, idx, n_offsets, score_idx=0),
        atol=SWEEP_ATOL)


def test_sparse_sweep_sums_rows_in_int32(monkeypatch):
    n, block = 512, 64
    i, j, _ = random_sweep(n, 1, 6000, 1)
    rng = np.random.default_rng(1)
    d0 = rng.uniform(0.0, 1.0, i.shape[0]).astype(np.float32)
    ts = np.linspace(0.05, 1.0, 8)
    _, edges = sparse_oracles.edges_both(i, j, d0, n)
    one_block, counts = tss.sweep_scores_sparse_device(edges, ts)
    monkeypatch.setattr(tss, "_TRI_BLOCK", block)
    (got, got_counts), copies, _ = widening_copies(
        lambda: tss.sweep_scores_sparse_device(edges, ts))
    w = (n + 31) // 32
    # only the [block] row sums are widened, never a [block, w] popcount
    assert copies and max(copies) < 8 * block * w
    np.testing.assert_array_equal(got, one_block)
    np.testing.assert_array_equal(got_counts, counts)
    # the port's oracles: the host scorer, the JAX package, exact counts
    sparse_oracles.check(i, j, d0, n, ts)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.max_memory_allocated "
                    "reads the card's allocator")
    return torch.device("cuda", 0)


def card_peak(device, fn):
    """(fn's result, its peak device bytes net of what was live before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(device) - base


@pytest.mark.cuda
def test_dense_sweep_peak_on_the_card(cuda_device):
    """At phase G's n the peak is two float32 squares (A and its product)
    plus one float64 row block of the product, within CARD_MARGIN; the
    whole-square float64 sum the sweep took before widens the whole
    product on the card too (8 n^2 bytes beside it)."""
    n, n_offsets = 8192, 4
    i, j, idx = random_sweep(n, n_offsets, 400_000, 2)
    got, peak = card_peak(cuda_device, lambda: tsweep.sweep_scores_device(
        n, i, j, idx, n_offsets, cuda_device))
    A = torch.zeros((n, n), dtype=torch.float32, device=cuda_device)
    A[i, j] = A[j, i] = 1.0
    whole, whole_peak = card_peak(
        cuda_device, lambda: (A @ A).mul_(A).sum(dtype=torch.float64))
    print(f"sweep peak {peak} bytes; whole-square sum peak {whole_peak} "
          f"bytes beside A (n = {n})")
    assert whole_peak >= 4 * n * n + 8 * n * n
    assert whole.item() == tsweep._paths(A).item()
    assert peak <= 2 * 4 * n * n + 8 * tsweep._SQUARE_ROWS * n + CARD_MARGIN
    np.testing.assert_allclose(
        got, grow_network_scores(n, i, j, idx, n_offsets, score_idx=0),
        atol=SWEEP_ATOL)


@pytest.mark.cuda
def test_sparse_sweep_step_within_its_budget_on_the_card(cuda_device):
    """One threshold of more than _TRI_BLOCK edges at n 32768: the peak is
    within sweep_peak_bytes' scoring terms for the edges' slots."""
    n = 32768
    i, j, _ = random_sweep(n, 1, 3 * tss._TRI_BLOCK, 3)
    e = i.shape[0]
    edges = tss.SweepEdges(
        torch.as_tensor(i, dtype=torch.int32, device=cuda_device),
        torch.as_tensor(j, dtype=torch.int32, device=cuda_device),
        torch.zeros(e, dtype=torch.float32, device=cuda_device), e, n)
    (_, counts), peak = card_peak(cuda_device, lambda: (
        tss.sweep_scores_sparse_device(edges, np.array([0.0]))))
    print(f"sparse sweep step peak {peak} bytes (n = {n}, {e} edges)")
    assert counts.tolist() == [e]
    w = (n + 31) // 32
    named = (2 * n * w * 4
             + (4 + tss._TRI_TRANSIENT_BLOCKS) * tss._TRI_BLOCK * w * 4)
    assert peak <= named + CARD_MARGIN
