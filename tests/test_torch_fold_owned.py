"""The streaming tier's owned-pair walk (poppunk_tpu_torch/scale.py
``_fold_block``) against a full-row reference built here, on the CPU and,
in the ``cuda`` cases, on the card.

The reference is the walk that counts every pair twice: each chunk's 2c
rows (its low rows and their mirrors) against every genome in one tile
(``_tile_dists``), folded by a gather over the low rows and a ``where``
with the reversed mirror rows, and each row's kNN taken from its own full
row (self and pads at +inf, the top-k of its ``_keys``). The walk under
test counts only the pairs each chunk owns and merges the kNN across
chunks, so the folded blocks, the kNN indices and distances, the column
maxima and the subsample must equal the reference's bit for bit; every
pair's arithmetic is the same whatever the tile's shape. The row- and the
column-sharded walks, on a virtual mesh of the CPU, must equal the one
device's.

The population: planted strains of random sketches with some genomes
copied, so that exact ties test the lowest-index rule, padded with zero
genomes and pack_planes' pad metadata where n_real < n_pad.
"""

import numpy as np
import pytest
import torch

import poppunk_tpu_torch.parallel.mesh as tmesh
import poppunk_tpu_torch.scale as tsc
from poppunk_tpu_torch import profiling

torch.set_num_threads(2)

KLIST = (13, 17, 21)
SS64 = 4
BBITS = 6
CPU = torch.device("cpu")

# (n_real, n_pad, chunk, knn, dist_col, copies (a, b): genome b = genome a)
CASES = {
    "pads-c64-k5": (601, 640, 64, 5, 0, ((0, 4), (3, 300), (5, 599),
                                         (10, 590))),
    "pads-c32-k1-acc": (601, 640, 32, 1, 1, ((0, 4), (7, 500))),
    "one-chunk": (64, 64, 32, 5, 0, ((1, 9), (2, 60))),
    "knn-past-chunk": (128, 128, 32, 40, 1, ((1, 9), (2, 127))),
    "small-pads-knn-past-chunk": (61, 64, 8, 12, 0, ((0, 4), (2, 59))),
    "no-knn": (61, 64, 8, 0, 0, ((0, 4),)),
}


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port computes on the card unless asked for the CPU (_device.py);
    these tests ask for it, and the cuda cases name the card."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
        yield


def population(n_real, n_pad, copies, seed=5):
    """Plane-major planes [K, P, n_pad, Wp] of 6 strains, lengths and
    frequencies; genomes past n_real are zero pads."""
    rng = np.random.default_rng(seed)
    w32, wp, _ = tsc.plane_geometry(SS64, BBITS)
    base = rng.integers(0, 2 ** 32, (6, len(KLIST), BBITS, w32),
                        dtype=np.uint64).astype(np.uint32)
    flip = rng.random((n_real, len(KLIST), BBITS, w32)) < 0.05
    noise = rng.integers(0, 2 ** 32, flip.shape,
                         dtype=np.uint64).astype(np.uint32)
    planes = np.zeros((n_pad, len(KLIST), BBITS, wp), np.uint32)
    planes[:n_real, ..., :w32] = np.where(flip, noise,
                                          base[np.arange(n_real) % 6])
    lengths = np.full(n_pad, 2_000_000, np.int32)
    lengths[:n_real] = rng.integers(1_900_000, 2_100_000, n_real)
    freqs = np.full((n_pad, 4), 0.25, np.float32)
    freqs[:n_real] = rng.dirichlet(np.full(4, 50.0), n_real)
    for a, b in copies:
        planes[b], lengths[b], freqs[b] = planes[a], lengths[a], freqs[a]
    return (np.ascontiguousarray(planes.transpose(1, 2, 0, 3)), lengths,
            freqs)


def on(device, planes, lengths, freqs):
    return (tsc.planes_to_tensor(planes, device),
            torch.as_tensor(lengths, device=device),
            torch.as_tensor(freqs, device=device))


def full_rows(planes, lengths, freqs, s, c, knn, dist_col, n_real):
    """The reference step: the chunk's 2c rows against every genome, the
    folded [c, n-1, 2] block and each row's kNN from its full row, [2c, k]
    (low rows, then the mirror rows ascending)."""
    n = planes.shape[2]
    dev = planes.device
    pad_bits = tsc.plane_geometry(SS64, BBITS)[2]
    rows = torch.cat([torch.arange(s, s + c), torch.arange(n - s - c, n - s)]
                     ).to(dev)
    d = tsc._tile_dists(planes[:, :, rows], planes, lengths[rows], lengths,
                        freqs[rows], freqs, KLIST, SS64, BBITS, pad_bits)
    i_vec = s + torch.arange(c, device=dev)
    q = torch.arange(n - 1, device=dev)
    idx_lo = (q[None, :] + i_vec[:, None] + 1) % n
    lo_part = torch.gather(d[:c], 1, idx_lo[..., None].expand(-1, -1, 2))
    in_first = q[None, :] < (n - 1 - i_vec)[:, None]
    folded = torch.where(in_first[..., None], lo_part,
                         d[c:].flip(0)[:, 1:, :])
    if n_real < n:
        pad_pair = torch.where(in_first,
                               q[None, :] + i_vec[:, None] + 1 >= n_real,
                               q[None, :] + 1 >= n_real)
        folded = folded.masked_fill(pad_pair[..., None], float("inf"))
    col = d[..., dist_col].contiguous()
    col[torch.arange(2 * c, device=dev), rows] = float("inf")
    col[:, n_real:] = float("inf")
    top_i, top_d = tsc._decode(tsc._smallest(tsc._keys(col), knn))
    return folded, rows, top_i, top_d


def reference_pass(planes, lengths, freqs, c, knn, dist_col, n_real):
    """(folded blocks, knn_col, knn_dist [n_real, k], column maxima) of the
    full-row walk."""
    n = planes.shape[2]
    blocks = []
    ki = np.zeros((n, knn), np.int64)
    kd = np.zeros((n, knn), np.float32)
    for s in range(0, n // 2, c):
        folded, rows, top_i, top_d = full_rows(planes, lengths, freqs, s, c,
                                               knn, dist_col, n_real)
        blocks.append(folded)
        ki[rows.cpu().numpy()] = top_i.cpu().numpy()
        kd[rows.cpu().numpy()] = top_d.cpu().numpy()
    flat = torch.cat(blocks).reshape(-1, 2)
    cmax = flat.masked_fill(torch.isinf(flat), float("-inf")).amax(dim=0)
    return blocks, ki[:n_real], kd[:n_real], cmax.cpu().numpy()


def bits(x):
    x = x.cpu() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return x.view(torch.int32)


def check_case(case, device):
    n_real, n_pad, c, knn, dist_col, copies = CASES[case]
    host = population(n_real, n_pad, copies)
    planes, lengths, freqs = on(device, *host)
    blocks, ki, kd, cmax = reference_pass(planes, lengths, freqs, c, knn,
                                          dist_col, n_real)
    pad_bits = tsc.plane_geometry(SS64, BBITS)[2]
    keys = tsc._knn_keys(n_pad, knn, device)
    for g, s in enumerate(range(0, n_pad // 2, c)):
        got = tsc._fold_block(planes, lengths, freqs, s, c, KLIST, SS64,
                              BBITS, pad_bits, keys, dist_col,
                              n_real if n_real < n_pad else None)
        assert torch.equal(bits(got), bits(blocks[g])), (case, s)
    got_i, got_d = tsc._knn_arrays([keys], device)
    np.testing.assert_array_equal(got_i[:n_real], ki)
    assert got_d[:n_real].tobytes() == kd.tobytes()
    # the walk of pass 1 and its subsample, the sweeps' walk without kNN
    cd = tsc.StreamingCondensed(*host, KLIST, SS64, BBITS, chunk=c, knn=knn,
                                dist_col=dist_col, n_real=n_real,
                                subsample=(300, 7), device=device)
    np.testing.assert_array_equal(cd.knn_col, ki)
    assert cd.knn_dist.tobytes() == kd.tobytes()
    assert cd.max_scale().tobytes() == cmax.tobytes()
    flat = torch.cat(blocks).reshape(-1, 2)
    pos = torch.as_tensor(cd._sub_flat, device=device)
    assert cd.subsample_pairs(300, seed=7).tobytes() == \
        flat[pos].cpu().numpy().tobytes()
    streamed = torch.cat([f for _, _, f in tsc._stream_pairs(cd)])
    assert torch.equal(bits(streamed), bits(flat))


@pytest.mark.parametrize("case", sorted(CASES))
def test_owned_walk_equals_the_full_rows(case):
    check_case(case, CPU)


@pytest.mark.parametrize("case", ["one-chunk", "knn-past-chunk"])
def test_buffered_fill_equals_the_full_rows(case):
    """fill_condensed_device (no pads) stores the reference's folded blocks
    and its kNN."""
    n_real, n_pad, c, knn, dist_col, copies = CASES[case]
    host = population(n_real, n_pad, copies)
    blocks, ki, kd, _ = reference_pass(*on(CPU, *host), c, knn, dist_col,
                                       n_real)
    cd = tsc.fill_condensed_device(*host, KLIST, SS64, BBITS, chunk=c,
                                   knn=knn, dist_col=dist_col, device=CPU)
    assert torch.equal(bits(cd.buf), bits(torch.cat(blocks)))
    np.testing.assert_array_equal(cd.knn_col, ki)
    assert cd.knn_dist.tobytes() == kd.tobytes()


@pytest.mark.parametrize("case,shards", [("pads-c64-k5", 5),
                                         ("small-pads-knn-past-chunk", 4),
                                         ("knn-past-chunk", 2)])
def test_row_sharded_mesh_equals_one_device(case, shards):
    """The row-sharded walk on a virtual mesh (the CPU repeated): each shard
    keeps a running kNN over every genome, merged at the fetch; the buffered
    fill over the same mesh when there are no pads."""
    n_real, n_pad, c, knn, dist_col, copies = CASES[case]
    host = population(n_real, n_pad, copies)
    kw = dict(knn=knn, dist_col=dist_col, n_real=n_real,
              subsample=(300, 7))
    mesh = tmesh.get_mesh(devices=[CPU] * shards)
    chunk = min(c, n_pad // 2 // shards)
    one = tsc.StreamingCondensed(*host, KLIST, SS64, BBITS, chunk=chunk,
                                 device=CPU, **kw)
    ts = tsc.StreamingCondensed(*host, KLIST, SS64, BBITS, chunk=chunk,
                                mesh=mesh, **kw)
    np.testing.assert_array_equal(ts.knn_col, one.knn_col)
    assert ts.knn_dist.tobytes() == one.knn_dist.tobytes()
    assert ts.max_scale().tobytes() == one.max_scale().tobytes()
    assert ts.subsample_pairs(300, seed=7).tobytes() == \
        one.subsample_pairs(300, seed=7).tobytes()
    if n_real == n_pad:
        got = tsc.fill_condensed_sharded(*host, KLIST, SS64, BBITS,
                                         mesh=mesh, chunk=chunk, knn=knn,
                                         dist_col=dist_col)
        np.testing.assert_array_equal(got.knn_col, one.knn_col)
        assert got.knn_dist.tobytes() == one.knn_dist.tobytes()


# (case, devices) of the column-sharded mesh: 8 columns a shard inside a
# chunk's 64 rows and the pads in the last, 16 inside 32 rows, shards as
# wide as a chunk or wider, and pads inside the last shard in each padded
# case
COL_CASES = [("pads-c64-k5", 8), ("pads-c32-k1-acc", 5), ("one-chunk", 4),
             ("knn-past-chunk", 8), ("small-pads-knn-past-chunk", 4),
             ("no-knn", 2)]


@pytest.mark.parametrize("case,shards", COL_CASES)
def test_column_sharded_mesh_equals_one_device(case, shards):
    """The column-sharded walk on a virtual mesh (the CPU repeated): each
    shard computes its cut of every chunk's owned tiles and keeps a
    running kNN over every genome, merged at the fetch."""
    n_real, n_pad, c, knn, dist_col, copies = CASES[case]
    host = population(n_real, n_pad, copies)
    kw = dict(chunk=c, knn=knn, dist_col=dist_col, n_real=n_real,
              subsample=(300, 7))
    one = tsc.StreamingCondensed(*host, KLIST, SS64, BBITS, device=CPU,
                                 **kw)
    ts = tsc.StreamingCondensed(*host, KLIST, SS64, BBITS,
                                mesh=tmesh.get_mesh(devices=[CPU] * shards),
                                shard_planes=True, **kw)
    assert ts._col and ts._n_dev == shards
    np.testing.assert_array_equal(ts.knn_col, one.knn_col)
    assert ts.knn_dist.tobytes() == one.knn_dist.tobytes()
    assert ts.max_scale().tobytes() == one.max_scale().tobytes()
    assert ts.subsample_pairs(300, seed=7).tobytes() == \
        one.subsample_pairs(300, seed=7).tobytes()


def tile_spans(monkeypatch, case, **kw):
    """(pairs of each scale.tile span, the number of scale.knn spans) of
    one pass 1 of ``case``."""
    n_real, n_pad, c, knn, dist_col, copies = CASES[case]
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.clear()
    try:
        tsc.StreamingCondensed(*population(n_real, n_pad, copies), KLIST,
                               SS64, BBITS, chunk=c, knn=knn,
                               dist_col=dist_col, n_real=n_real, **kw)
        return ([s.counts["pairs"] for s in profiling.spans()
                 if s.name == "scale.tile"],
                sum(s.name == "scale.knn" for s in profiling.spans()))
    finally:
        profiling.clear()


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiles_count_the_owned_pairs(case, monkeypatch):
    """Two scale.tile spans a chunk, c (n_pad - s) and c (s + c) pairs: in
    all chunks * c * (n_pad + c), about half the full rows' 2c n_pad; one
    scale.knn span a tile when there is a kNN."""
    _, n_pad, c, knn, _, _ = CASES[case]
    tiles, knns = tile_spans(monkeypatch, case, device=CPU)
    starts = range(0, n_pad // 2, c)
    assert tiles == [p for s in starts
                     for p in (c * (n_pad - s), c * (s + c))]
    assert sum(tiles) == len(starts) * c * (n_pad + c)
    assert knns == (len(tiles) if knn else 0)


@pytest.mark.parametrize("case,shards", COL_CASES)
def test_column_tiles_count_the_owned_pairs(case, shards, monkeypatch):
    """Column shards cut the same owned tiles: their scale.tile pairs sum
    to chunks * c * (n_pad + c), with one scale.knn span a cut tile."""
    _, n_pad, c, knn, _, _ = CASES[case]
    tiles, knns = tile_spans(monkeypatch, case, shard_planes=True,
                             mesh=tmesh.get_mesh(devices=[CPU] * shards))
    assert sum(tiles) == n_pad // 2 // c * c * (n_pad + c)
    assert len(tiles) > 2 * n_pad // 2 // c
    assert knns == (len(tiles) if knn else 0)


def test_the_column_operand_is_a_view_of_the_resident_planes(monkeypatch):
    """Each owned tile counts row-slice views of the resident planes, the
    queries and the columns both: no copy of the planes is made."""
    n_real, n_pad, c, knn, dist_col, copies = CASES["one-chunk"]
    planes, lengths, freqs = on(CPU, *population(n_real, n_pad, copies))
    seen = []
    real = tsc.match_counts_device

    def spy(pq, pr, pad_bits, plane_major=False):
        seen.append((pq.data_ptr(), pq.shape[2], pr.data_ptr(),
                     pr.shape[2]))
        return real(pq, pr, pad_bits, plane_major=plane_major)

    monkeypatch.setattr(tsc, "match_counts_device", spy)
    pad_bits = tsc.plane_geometry(SS64, BBITS)[2]
    tsc._fold_block(planes, lengths, freqs, 0, c, KLIST, SS64, BBITS,
                    pad_bits)
    row = planes.stride(2) * planes.element_size()
    base = planes.data_ptr()
    assert seen == [(base, c, base, n_pad),
                    (base + (n_pad - c) * row, c, base + (n_pad - c) * row,
                     c)]


# --------------------------------------------------------------------------
# on the card (skipped on a host without CUDA)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_owned_walk_equals_the_full_rows_on_the_card(case):
    """The same holds on the card, where both tiles are views of the
    resident planes read in place by the kernel's plane-major route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    check_case(case, torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pads-c64-k5", "knn-past-chunk"])
def test_row_sharded_mesh_equals_one_device_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    n_real, n_pad, c, knn, dist_col, copies = CASES[case]
    host = population(n_real, n_pad, copies)
    kw = dict(chunk=c // 2, knn=knn, dist_col=dist_col, n_real=n_real)
    one = tsc.StreamingCondensed(*host, KLIST, SS64, BBITS, device=card,
                                 **kw)
    ts = tsc.StreamingCondensed(*host, KLIST, SS64, BBITS,
                                mesh=tmesh.get_mesh(devices=[card] * 2),
                                **kw)
    np.testing.assert_array_equal(ts.knn_col, one.knn_col)
    assert ts.knn_dist.tobytes() == one.knn_dist.tobytes()
    assert ts.max_scale().tobytes() == one.max_scale().tobytes()
