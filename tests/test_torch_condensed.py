"""condensed_self_block (poppunk_tpu_torch/ops/distances.py) writes each
chunk's condensed rows straight into one output allocated per call. Held
here, bit for bit, to the chunks' rows sliced and concatenated (the way the
engine assembled its output before), on the CPU at every chunking and
output kind, with whole chunks sharded over a mesh and the last not, and
on a card through the page-locked staging pair."""

import gc
import weakref

import numpy as np
import pytest
import torch

from poppunk_tpu_torch import profiling
from poppunk_tpu_torch.ops import distances as td
from poppunk_tpu_torch.parallel.mesh import get_mesh

KLIST = (15, 18, 21)
SS64 = 2
BBITS = 3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    """The port computes on the card unless asked for the CPU (_device.py);
    the card's test passes its device explicitly. Recording starts off."""
    monkeypatch.setenv("POPPUNK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(profiling, "_ENABLED", False)
    profiling.clear()
    yield
    profiling.clear()


def _population(n, seed=0, strains=4):
    """Planes of a few strains, each genome its strain's words with a share
    of them redrawn, so that the distances, and the classes on them, vary."""
    rng = np.random.default_rng(seed)
    w32, wp, _ = td.plane_geometry(SS64, BBITS)
    shape = (len(KLIST), BBITS, w32)
    base = rng.integers(0, 2 ** 32, (strains,) + shape, dtype=np.uint64)
    planes = np.zeros((n, len(KLIST), BBITS, wp), np.uint32)
    for i in range(n):
        words = base[rng.integers(strains)].copy()
        redrawn = rng.random(shape) < rng.uniform(0.0, 0.6)
        words[redrawn] = rng.integers(0, 2 ** 32, int(redrawn.sum()),
                                      dtype=np.uint64)
        planes[i, ..., :w32] = words.astype(np.uint32)
    lengths = rng.integers(4_000_000, 5_000_000, n).astype(np.int32)
    freqs = rng.dirichlet(np.full(4, 8.0), n).astype(np.float32)
    return planes, lengths, freqs


def _f32(*values):
    return tuple(torch.tensor(v, dtype=torch.float32) for v in values)


def _post(kind):
    """(jaccard, post_spec) of an output kind: distances, Jaccards, or
    distances with int8 boundary classes or int16 grid labels."""
    if kind == "boundary":
        return False, ("boundary", (2,), _f32([1.0, 1.0], 0.5, 0.5))
    if kind == "grid":
        labels = torch.arange(64, dtype=torch.int16).reshape(8, 8) - 3
        return False, ("dbscan", (), (labels,) + _f32(
            0.0, 1.0 / 8, 0.0, 1.0 / 8, [1.0, 1.0]))
    return kind == "jaccard", None


def _concatenated(pop, chunk, jaccard, post_spec, device):
    """The expected value: every chunk's result moved to the host with
    ``.cpu()``, its rows sliced to the pairs with later genomes, and the
    slices concatenated."""
    planes, lengths, freqs = pop
    n = planes.shape[0]
    pad_bits = td.plane_geometry(SS64, BBITS)[2]
    ops = td._Operands(planes, lengths, freqs, device, pad_bits)
    rows = [[], []]
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        o = td._dist_chunk(ops.rows(start, stop), ops.rows(start, n), KLIST,
                           SS64, BBITS, True, True, jaccard, post_spec)
        for part, into in zip((o,) if post_spec is None else o, rows):
            block = part.cpu().numpy()
            into.extend(block[local, local + 1:]
                        for local in range(stop - start))
    out = [np.concatenate(r, axis=0) for r in rows if r]
    return out[0] if post_spec is None else tuple(out)


def _condensed(pop, chunk, jaccard, post_spec, device):
    return td.condensed_self_block(*pop, KLIST, SS64, BBITS, jaccard=jaccard,
                                   chunk=chunk, post_spec=post_spec,
                                   device=device)


def _assert_same(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kind", ["dists", "jaccard", "boundary", "grid"])
@pytest.mark.parametrize("n,chunk", [(96, 32), (100, 32), (20, 64), (2, 64)],
                         ids=["divides", "ragged", "one_chunk", "two"])
def test_rows_placed_equal_the_concatenation(n, chunk, kind):
    jaccard, post_spec = _post(kind)
    pop = _population(n, seed=n + chunk)
    want = _concatenated(pop, chunk, jaccard, post_spec, CPU)
    got = _condensed(pop, chunk, jaccard, post_spec, CPU)
    _assert_same(got, want)
    width = len(KLIST) if jaccard else 2
    first = got if post_spec is None else got[0]
    assert first.shape == (n * (n - 1) // 2, width)
    if post_spec is not None and n > 2:
        assert len(np.unique(got[1])) > 1  # the classes vary
    # the caller holds the output alone, and the next call gets its own
    again = _condensed(pop, chunk, jaccard, post_spec, CPU)
    _assert_same(again, want)
    outs = got if post_spec else (got,)
    assert not any(np.shares_memory(a, b) for a, b in
                   zip(outs, again if post_spec else (again,)))
    held = [weakref.ref(a) for a in outs]
    del got, first, outs
    gc.collect()
    assert all(ref() is None for ref in held)


def test_no_genomes_raise():
    pop = _population(0)
    with pytest.raises(ValueError, match="at least one genome"):
        _condensed(pop, 32, False, None, CPU)


def _mixed(n, chunk, devices, routes):
    """An _auto_mesh that shards the whole chunks over a mesh of
    ``devices`` and leaves the ragged last one to the single route, as its
    rule does on a host of two or more cards when chunk does not divide n;
    ``routes`` gets True for each chunk sharded, False for the others."""
    def auto_mesh(device, n_pairs):
        routes.append(n_pairs >= n * chunk)
        return get_mesh(devices=devices) if routes[-1] else None
    return auto_mesh


@pytest.mark.parametrize("kind", ["dists", "boundary"])
@pytest.mark.parametrize("n,chunk", [(70, 32), (40, 32)],
                         ids=["two_sharded", "one_sharded"])
def test_mixed_routes_equal_the_single_route(n, chunk, kind, monkeypatch):
    """Whole chunks on a mesh, the ragged last chunk on the single route:
    the rows equal the single route's concatenation bit for bit."""
    jaccard, post_spec = _post(kind)
    pop = _population(n, seed=3 * n)
    want = _concatenated(pop, chunk, jaccard, post_spec, CPU)
    routes = []
    monkeypatch.setattr(td, "_auto_mesh", _mixed(n, chunk, [CPU, CPU],
                                                 routes))
    got = _condensed(pop, chunk, jaccard, post_spec, CPU)
    assert routes == [True] * (n // chunk) + [False]
    _assert_same(got, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the page-locked staging route needs a CUDA card")
    from poppunk_tpu_torch import _device

    _device.set_full_precision()
    return torch.device("cuda", 0)


@pytest.fixture
def staging_buffers(monkeypatch):
    """Every page-locked buffer condensed_self_block takes."""
    taken = []
    real = td._staging

    def counted(nbytes, count):
        taken.extend(real(nbytes, count))
        return taken[-count:]

    monkeypatch.setattr(td, "_staging", counted)
    return taken


@pytest.mark.cuda
@pytest.mark.parametrize("recording", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("kind", ["dists", "jaccard", "grid"])
def test_staged_rows_equal_the_concatenation_on_a_card(cuda_device, kind,
                                                       recording,
                                                       staging_buffers,
                                                       monkeypatch):
    """Five chunks, so each staging buffer serves more than one; the rows
    equal ``.cpu()`` and the concatenation bit for bit, with spans on and
    off; two page-locked buffers, every chunk's copy staged."""
    monkeypatch.setattr(profiling, "_ENABLED", recording)
    jaccard, post_spec = _post(kind)
    n, chunk = 300, 64
    pop = _population(n, seed=7)
    got = _condensed(pop, chunk, jaccard, post_spec, cuda_device)
    want = _concatenated(pop, chunk, jaccard, post_spec, cuda_device)
    _assert_same(got, want)
    assert len(staging_buffers) == 2
    assert all(b.is_pinned() for b in staging_buffers)
    calls = -(-n // chunk)
    spans = profiling.spans()
    if recording:
        assert len([s for s in spans
                    if s.name == "dists.fetch_copy"]) == calls
        ready = [s.counts["ready"] for s in spans
                 if s.name == "dists.fetch_wait"]
        assert len(ready) == calls and set(ready) <= {0, 1}
    else:
        assert spans == []


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dists", "grid"])
@pytest.mark.parametrize("n,chunk", [(600, 512), (1100, 512)],
                         ids=["one_sharded", "two_sharded"])
def test_mixed_routes_on_a_card(cuda_device, n, chunk, kind,
                                staging_buffers, monkeypatch):
    """Whole chunks on a two-device mesh of the card, the ragged last one
    staged, as on a host of two or more cards: one page-locked buffer, and
    the rows equal the single route's bit for bit."""
    jaccard, post_spec = _post(kind)
    pop = _population(n, seed=n)
    want = _concatenated(pop, chunk, jaccard, post_spec, cuda_device)
    routes = []
    monkeypatch.setattr(td, "_auto_mesh", _mixed(
        n, chunk, [cuda_device, cuda_device], routes))
    got = _condensed(pop, chunk, jaccard, post_spec, cuda_device)
    assert routes == [True] * (n // chunk) + [False]
    _assert_same(got, want)
    assert len(staging_buffers) == 1
