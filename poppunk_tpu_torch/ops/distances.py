"""Sketch distance engine: planes -> match counts -> Jaccards -> (core, acc).

Counterpart of poppunk_tpu/ops/distances.py, per query chunk:

    packed bit-plane sketches (int32 words on the distance device)
      -> bin match counts          ops/match_counts.py (CUDA kernel / twin;
                                   standard or packed-lane by KERNEL_CHOICE)
      -> b-bit + random-match corrected Jaccard per k   one dist_epilogue
      -> constrained log-linear fit across k            launch: CUDA kernel
                                                        (csrc/dist_epilogue.cu)
                                                        or its torch twin
      -> (core, accessory) per pair, optionally classified (fused_assign)

The engine's host work runs in ``profiling`` spans named ``dists.*``
(profiling.py lists them); they record only while recording is on.

Row conventions are the reference's (PopPUNK/utils.py:199-226,
PopPUNK/assign.py:690): self mode returns condensed i<j rows, query mode
row ``q * n_ref + r``. Host arrays come in and go out as numpy; the
reference planes move to the device, and under the packed choice are
packed, once per call.
"""

import ctypes

import numpy as np
import torch

from .. import _build, _device, profiling
from .kmer_fit import _fit_math
from . import match_counts as mc

_LANES = 128

EPILOGUE_LAUNCHES = 0  # dist_epilogue kernel launches in this process
# csrc/dist_epilogue.cu: MAX_K, the most k-mer lengths it takes, and its
# instantiations' KMAX, the first at least K taken at launch
EPILOGUE_MAX_K = 32
EPILOGUE_KMAX = (8, 32)


def plane_geometry(sketchsize64, bbits):
    """(w32, Wp, pad_bits): useful words per plane row, the row length
    padded to the reference's 128-word layout, and the pad in bits."""
    w32 = 2 * sketchsize64
    wp = ((w32 + _LANES - 1) // _LANES) * _LANES
    return w32, wp, (wp - w32) * 32


# pack_planes moves the bin words of this many genomes at a time: their
# stacked words, K x sketchsize64 x P uint64 a genome (13 MB a block at
# K 6, sketch 9984, 14 planes), are its one temporary
PACK_BLOCK = 128


def pack_planes(sketches, klist=None, plane_major=False, pad_to_even=False,
                pad_to=None, out=None):
    """Sketch objects -> (planes uint32[n, K, P, Wp], lengths int32[n],
    freqs f32[n, 4]) — the reference's device layout, bit for bit.

    HDF5 usigs are uint64[sketchsize64 * bbits], word w plane p at index
    w * bbits + p; each plane row holds the uint64 words split into
    (low32, high32) pairs. ``plane_major=True`` emits [K, P, n, Wp], the
    layout the streaming scale tier keeps resident. ``pad_to_even`` appends
    one all-zero pad genome when n is odd; ``pad_to=m`` pads with zero
    genomes up to m >= n (the folded layout's chunk divisibility). Pad
    genomes get the reference's innocuous metadata; the scale tier masks
    them exactly through ``n_real``.

    ``out=(planes, lengths, freqs)``: arrays of those shapes (numpy, or
    CPU tensors; the planes int32 or uint32) written in place of new ones,
    whatever they held; returned as numpy views. The span's ``staged``
    counts their bytes when they are page-locked (0 otherwise).

    On a little-endian host a plane row's (low32, high32) pairs are the
    uint64 words themselves, so row (k, p) is the word-major usigs of k
    read at stride P from p. The words move PACK_BLOCK genomes at a time:
    the block's usigs stacked into one uint64 [b, K, ss64, P], then
    written transposed into the uint64 view of each row's first ss64
    words in one strided copy over torch's intra-op threads."""
    ss64 = sketches[0].sketchsize64
    bbits = sketches[0].bbits
    if klist is None:
        klist = sorted(sketches[0].usigs.keys())
    klist = [int(k) for k in klist]
    _, wp, _ = plane_geometry(ss64, bbits)
    n_real = len(sketches)
    if pad_to is not None:
        if pad_to < n_real:
            raise ValueError(f"pad_to ({pad_to}) < population ({n_real})")
        n = int(pad_to)
    else:
        n = n_real + (n_real % 2 if pad_to_even else 0)
    K = len(klist)
    shape = (K, bbits, n, wp) if plane_major else (n, K, bbits, wp)
    if out is None:
        planes = np.empty(shape, dtype=np.uint32)
        lengths = np.empty(n, dtype=np.int32)
        freqs = np.empty((n, 4), dtype=np.float32)
        staged = 0
    else:
        (planes, lengths, freqs), staged = _pack_destination(
            out, (shape, (n,), (n, 4)))
    with profiling.span("dists.pack_planes", sketches=n_real,
                        staged=staged):
        for sk in sketches:
            if sk.sketchsize64 != ss64 or sk.bbits != bbits:
                raise ValueError("Inconsistent sketch geometry")
        lengths[:n_real] = [sk.length for sk in sketches]
        freqs[:n_real] = [sk.base_freq for sk in sketches]
        lengths[n_real:] = 2_000_000
        freqs[n_real:] = 0.25
        words = torch.from_numpy(planes.view(np.int64))  # [..., Wp / 2]
        if plane_major:
            words = words.permute(2, 0, 1, 3)
        words[:, :, :, ss64:].zero_()
        words[n_real:].zero_()
        stack = np.empty((min(PACK_BLOCK, n_real), K, ss64 * bbits),
                         dtype=np.uint64)
        for a in range(0, n_real, PACK_BLOCK):
            block = sketches[a:a + PACK_BLOCK]
            rows = stack[:len(block)]
            for row, sk in zip(rows, block):
                for ki, k in enumerate(klist):
                    row[ki] = sk.usigs[k]
            src = torch.from_numpy(rows.view(np.int64)).view(
                len(block), K, ss64, bbits)
            words[a:a + len(block), :, :, :ss64].copy_(src.transpose(2, 3))
    return planes, lengths, freqs


def _pack_destination(out, shapes):
    """pack_planes' ``out`` as numpy views (planes uint32, lengths int32,
    freqs float32) checked against the output's ``shapes``, and their
    bytes if every one is a page-locked tensor, else 0."""
    kinds = ((np.uint32, np.int32), (np.int32,), (np.float32,))
    views = []
    for a, shape, dtypes in zip(out, shapes, kinds):
        host = a.numpy() if torch.is_tensor(a) else a
        if host.shape != shape or host.dtype not in dtypes:
            raise ValueError(f"pack_planes out: {host.dtype} {host.shape}, "
                             f"wanted {dtypes[0].__name__} {shape}")
        views.append(host)
    views[0] = views[0].view(np.uint32)
    pinned = all(torch.is_tensor(a) and a.is_pinned() for a in out)
    return views, sum(v.nbytes for v in views) if pinned else 0


# Host arrays of more than this many bytes go to a card through two
# page-locked slabs of this size (_slab_copy); smaller ones, and every copy
# to the CPU, in one .to(device). 16 MB was the fastest of 8-256 MB for
# 1.1 and 2.6 GB on an H100's host (PERF.md §5)
UPLOAD_SLAB = 16 << 20


def planes_to_tensor(planes, device=None):
    """uint32 planes (numpy) -> int32 tensor with the same bits, on
    ``device`` (None: ``_device.resolve``'s choice)."""
    return _upload(planes, device)[0]


def _upload(planes, device=None):
    """planes_to_tensor, and the bytes that went through page-locked slabs:
    an array of more than UPLOAD_SLAB bytes bound for a card takes
    _slab_copy (a pageable ``.to(device)`` runs at the driver's own
    staging rate, ~5.4 GB/s on the H100's host); anything else one
    ``.to(device)``, 0 staged."""
    device = _device.resolve(device)
    if device.type != "cuda" or planes.nbytes <= UPLOAD_SLAB:
        return torch.from_numpy(
            np.ascontiguousarray(planes).view(np.int32)).to(device), 0
    dst = torch.empty(planes.shape, dtype=torch.int32, device=device)
    _slab_copy(planes, dst, UPLOAD_SLAB)
    return dst, planes.nbytes


def _slab_ranges(nbytes, slab):
    """The byte ranges [a, b) of _slab_copy's slabs, in order."""
    return [(a, min(a + slab, nbytes)) for a in range(0, nbytes, slab)]


def _slab_copy(planes, dst, slab):
    """Copy the bits of the uint32 host array ``planes`` into ``dst``, a
    contiguous int32 tensor of its shape, ``slab`` bytes at a time through
    two reused host buffers (_staging). On a card they are page-locked and
    each slab's copy out of its buffer is asynchronous, with an event
    recorded after it; before slab i fills its buffer the host waits for
    that event of slab i - 2 alone, never the stream, so the host copies
    slab i (over torch's intra-op threads) while the card's DMA takes
    slab i - 1. Returns without waiting: later work on the stream queues
    behind the copies, and the caching host allocator keeps a freed
    buffer until its copy's event has passed. On the CPU each slab goes
    through its (pageable) buffer as it comes."""
    on_card = dst.device.type == "cuda"
    src = torch.from_numpy(np.ascontiguousarray(planes).view(np.int32))
    src, dst = (t.view(-1).view(torch.uint8) for t in (src, dst))
    ranges = _slab_ranges(src.numel(), slab)
    buffers = _staging(min(slab, src.numel()), min(2, len(ranges)),
                       pinned=on_card)
    events = [None] * len(buffers)
    for i, (a, b) in enumerate(ranges):
        j = i % 2
        if events[j] is not None:
            events[j].synchronize()
        buffer = buffers[j][:b - a]
        buffer.copy_(src[a:b])
        dst[a:b].copy_(buffer, non_blocking=on_card)
        if on_card:
            events[j] = torch.cuda.Event()
            events[j].record(torch.cuda.current_stream(dst.device))


def _dot4(a, b):
    """[nq, 4] x [nr, 4] -> f32 [nq, nr] of sum_c a[:, c] * b[:, c], as
    separate products and sums in a fixed order. A matmul's blocking
    depends on the tile's shape, so its last bit would too; this result
    is the same whatever the tile (a query chunk, a mesh shard), which
    keeps the sharded block and the classes on it bit-equal to the
    single-device ones."""
    out = a[:, 0, None] * b[None, :, 0]
    for c in range(1, a.shape[1]):
        out = out + a[:, c, None] * b[None, :, c]
    return out


def _random_match_dots(freq_q, freq_r, use_rc=True):
    """(dot, reverse-complement dot or None) of the base compositions."""
    dot = _dot4(freq_q, freq_r)
    # ACGT reversed is the complement permutation
    return dot, (_dot4(freq_q, torch.flip(freq_r, dims=[1])) if use_rc
                 else None)


def pow_f64(x, k):
    """float32 ``x ** k`` for a non-negative integer ``k``, rounded once:
    ``x`` widened to float64, squared and multiplied over the bits of ``k``
    from the lowest (the running square times the result where a bit is
    set), then cast to float32. csrc/dist_epilogue.cu runs the same chain
    of float64 multiplies, so the two stay bit-equal; the result is within
    half a float32 ulp plus ~1e-15 relative of the exact power (float32
    ``pow`` is not correctly rounded, and x * x * x rounds twice)."""
    if float(k) != int(k) or int(k) < 0:
        raise ValueError(f"pow_f64 takes a non-negative integer exponent, "
                         f"not {k}")
    k = int(k)
    if k == 0:
        return torch.ones_like(x)
    base, out = x.to(torch.float64), None
    while True:
        if k & 1:
            out = base if out is None else out * base
        k >>= 1
        if not k:
            return out.to(torch.float32)
        base = base * base


def _random_jaccard_dots(k, len_q, len_r, dots):
    """_random_jaccard from the precomputed _random_match_dots."""
    dot, dot_rc = dots
    p = pow_f64(dot, k)  # [nq, nr]
    if dot_rc is not None:
        p = p + pow_f64(dot_rc, k)
    n1 = (len_q.to(torch.float32) - k + 1).clamp(min=1.0)[:, None]
    n2 = (len_r.to(torch.float32) - k + 1).clamp(min=1.0)[None, :]
    inter = n1 * n2 * p
    union = n1 + n2 - inter
    r = torch.where(union <= 0, 1.0, inter / union.clamp(min=1e-30))
    return r.clamp(0.0, 1.0 - 1e-6)


def _random_jaccard(k, len_q, len_r, freq_q, freq_r, use_rc=True):
    """Expected Jaccard of two random sequences with these lengths and
    base compositions (torch twin of sketch/random_match.py and the
    reference's _random_jaccard_jnp). The 4-wide dots run in float32,
    in a fixed order (_dot4)."""
    return _random_jaccard_dots(k, len_q, len_r,
                                _random_match_dots(freq_q, freq_r, use_rc))


def corrected_jaccards(matches, klist, len_q, len_r, freq_q, freq_r,
                       sketchsize64, bbits, random_correct=True, use_rc=True):
    """int32 matches [nq, nr, K] -> corrected Jaccard f32 [nq, nr, K]."""
    nbins = sketchsize64 * 64
    expected = 2.0 ** (-bbits)
    obs = matches.to(torch.float32) / nbins
    j = ((obs - expected) / (1.0 - expected)).clamp(0.0, 1.0)
    if random_correct:
        dots = _random_match_dots(freq_q, freq_r, use_rc)
        r = torch.stack([_random_jaccard_dots(float(k), len_q, len_r, dots)
                         for k in klist], dim=-1)
        j = ((j - r) / (1.0 - r)).clamp(0.0, 1.0)
    return j


def core_accessory(jaccards, klist):
    """Fit the k-mer curve for every pair: [..., K] -> f32 [..., 2]."""
    k = torch.as_tensor(list(klist), dtype=torch.float32,
                        device=jaccards.device)
    core, acc = _fit_math(jaccards.to(torch.float32), k)
    return torch.stack([core, acc], dim=-1)


def dist_epilogue_torch(matches, klist, len_q, len_r, freq_q, freq_r,
                        sketchsize64, bbits, random_correct=True, use_rc=True,
                        jaccard=False, out=None):
    """The plain version of the epilogue kernel: corrected_jaccards, then
    core_accessory unless ``jaccard``; into ``out`` when given."""
    d = corrected_jaccards(matches, klist, len_q, len_r, freq_q, freq_r,
                           sketchsize64, bbits, random_correct, use_rc)
    if not jaccard:
        d = core_accessory(d, klist)
    return d if out is None else out.copy_(d)


def _epilogue_operands(matches, klist, len_q, len_r, freq_q, freq_r, jaccard,
                       out):
    """Validate the epilogue's operands; return (nq, nr, K)."""
    if matches.dim() != 3:
        raise ValueError(f"matches must be [nq, nr, K], got "
                         f"{tuple(matches.shape)}")
    nq, nr, K = matches.shape
    if K != len(klist):
        raise ValueError(f"matches hold {K} k-mer lengths, klist {len(klist)}")
    if not 1 <= K <= EPILOGUE_MAX_K:
        raise ValueError(f"the epilogue takes 1 to {EPILOGUE_MAX_K} k-mer "
                         f"lengths, got {K}")
    if any(float(k) != int(k) or int(k) < 1 for k in klist):
        raise ValueError(f"k-mer lengths must be positive integers: {klist}")
    width = K if jaccard else 2
    named = [("matches", matches, torch.int32, (nq, nr, K)),
             ("len_q", len_q, torch.int32, (nq,)),
             ("len_r", len_r, torch.int32, (nr,)),
             ("freq_q", freq_q, torch.float32, (nq, 4)),
             ("freq_r", freq_r, torch.float32, (nr, 4))]
    if out is not None:
        named.append(("out", out, torch.float32, (nq, nr, width)))
    for name, t, dtype, shape in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for _, t, _, _ in named}
    if len(devices) != 1:
        raise ValueError(f"the epilogue's operands lie on "
                         f"{sorted(map(str, devices))}")
    return nq, nr, K


def dist_epilogue(matches, klist, len_q, len_r, freq_q, freq_r, sketchsize64,
                  bbits, random_correct=True, use_rc=True, jaccard=False,
                  out=None):
    """int32 match counts [nq, nr, K] -> float32 (core, accessory) [nq, nr,
    2], or the corrected Jaccards [nq, nr, K] with ``jaccard``, written into
    ``out`` when given: csrc/dist_epilogue.cu on CUDA tensors, one launch;
    dist_epilogue_torch on CPU tensors. Lengths are int32 [n], frequencies
    float32 [n, 4], everything contiguous on one device; a CUDA input the
    kernel cannot take raises.

    The kernel: one thread per pair, a block 256 references of one query
    row. Its instantiation for the largest K, EPILOGUE_KMAX 8 or 32, is
    taken from K, so the log j and the fit's partial sums stay in
    registers. dot^k is pow_f64's float64 chain.

    The kernel's Jaccards equal the plain version's on the card bit for
    bit, and its distances are within DIST_TOL of them (equal under torch
    2.11, whose CUDA reduction order the fit's sums follow); the note atop
    the source gives the contract. The scalar constants go to the kernel
    as the plain version's Python values, computed in double and cast to
    float32."""
    global EPILOGUE_LAUNCHES
    nq, nr, K = _epilogue_operands(matches, klist, len_q, len_r, freq_q,
                                   freq_r, jaccard, out)
    if matches.device.type == "cpu":
        return dist_epilogue_torch(matches, klist, len_q, len_r, freq_q,
                                   freq_r, sketchsize64, bbits,
                                   random_correct, use_rc, jaccard, out)
    if matches.device.type != "cuda":
        raise ValueError(f"the epilogue runs on the CPU or a CUDA card, not "
                         f"{matches.device}")
    if out is None:
        out = torch.empty((nq, nr, K if jaccard else 2), dtype=torch.float32,
                          device=matches.device)
    elif not jaccard and out.data_ptr() % 8:
        raise ValueError("out must start on an 8-byte boundary: the kernel "
                         "stores each pair's (core, accessory) as one float2")
    if nq == 0 or nr == 0:
        return out
    nbins = sketchsize64 * 64
    expected = 2.0 ** (-bbits)
    kvals = (ctypes.c_float * K)(*(float(k) for k in klist))
    lib = _build.load()
    with torch.cuda.device(matches.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dist_epilogue_launch(
            matches.data_ptr(), len_q.data_ptr(), len_r.data_ptr(),
            freq_q.data_ptr(), freq_r.data_ptr(), out.data_ptr(), nq, nr, K,
            ctypes.addressof(kvals), float(np.float32(nbins)),
            float(np.float32(expected)), float(np.float32(1.0 - expected)),
            float(np.float32(1.0 - 1e-6)), int(random_correct), int(use_rc),
            int(jaccard), stream)
    if err:
        raise RuntimeError(f"dist_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    EPILOGUE_LAUNCHES += 1
    return out


def _dist_chunk(qry, ref, klist, sketchsize64, bbits, random_correct,
                use_rc, jaccard, post_spec=None):
    """One query chunk against the references; ``qry`` and ``ref`` are
    (planes, lengths, freqs) tensors on the distance device: the
    match-count kernel, then one epilogue launch (dist_epilogue), as the
    reference's jitted chunk runs them. Returns dists, or (dists, classes)
    with a post."""
    (planes_q, len_q, freq_q), (planes_r, len_r, freq_r) = qry, ref
    _, _, pad_bits = plane_geometry(sketchsize64, bbits)
    with profiling.span("dists.enqueue",
                        pairs=len_q.shape[0] * len_r.shape[0]):
        matches = mc.match_counts_device(planes_q, planes_r, pad_bits)
        d = dist_epilogue(matches, klist, len_q, len_r, freq_q, freq_r,
                          sketchsize64, bbits, random_correct, use_rc,
                          jaccard)
        if jaccard or post_spec is None:
            return d
        from .fused_assign import apply_post

        return d, apply_post(d, post_spec)


class _Operands:
    """Planes, lengths and base frequencies of a genome set, on a device.
    Under the packed kernel choice the planes are packed here, once, and
    ``rows`` hands out views of the packed tensor."""

    def __init__(self, planes, lengths, freqs, device, pad_bits):
        moved = (0 if device.type == "cpu" else
                 sum(a.nbytes for a in (planes, lengths, freqs)
                     if not torch.is_tensor(a) or a.device.type == "cpu"))
        with profiling.span("dists.upload", bytes=moved) as sp:
            self.planes, staged = _upload(planes, device)
            sp.add(staged=staged)
            if mc.KERNEL_CHOICE == "packed":
                self.planes = mc.pack(self.planes, pad_bits)
            self.lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                           device=device)
            self.freqs = torch.as_tensor(freqs, dtype=torch.float32,
                                         device=device)

    def rows(self, start, stop):
        planes = (self.planes.rows(start, stop)
                  if isinstance(self.planes, mc.PackedPlanes)
                  else self.planes[start:stop])
        return planes, self.lengths[start:stop], self.freqs[start:stop]


def _to_host(out, post_spec):
    """A chunk's result (one tensor, or two with a post) as numpy. While
    spans record, the wait for the chunk's work and the copy are apart:
    dists.fetch_wait takes the host memory, as ``.cpu()`` does before it
    copies, and synchronises the device's current stream; otherwise the
    copy alone waits, as it must."""
    parts = (out,) if post_spec is None else out
    if profiling.recording():
        with profiling.span("dists.fetch_wait"):
            host = [torch.empty_like(t, device="cpu") for t in parts]
            if parts[0].device.type == "cuda":
                torch.cuda.current_stream(parts[0].device).synchronize()
        with profiling.span("dists.fetch_copy",
                            bytes=sum(t.nbytes for t in parts)):
            for h, t in zip(host, parts):
                h.copy_(t)
    else:
        host = [t.cpu() for t in parts]
    return host[0].numpy() if post_spec is None else tuple(
        h.numpy() for h in host)


# Below this many pairs the sharding overhead outweighs the parallelism;
# small problems take the single-device path
_SHARD_MIN_PAIRS = 1 << 16


def _auto_mesh(device, n_pairs):
    """The mesh pairwise_block shards over when the caller leaves it to
    the reference's rule: the computing device is a card, the default mesh
    (every visible card of every process) holds more than one device, and
    the block has at least _SHARD_MIN_PAIRS pairs; n_q = 2 when the device
    count is even and above 2. None: the single-device path."""
    if device.type != "cuda" or n_pairs < _SHARD_MIN_PAIRS:
        return None
    from ..parallel.mesh import default_device_count, get_mesh

    n_dev = default_device_count()
    if n_dev < 2:
        return None
    return get_mesh(n_dev, n_q=2 if n_dev % 2 == 0 and n_dev > 2 else 1)


def pairwise_block(planes_q, planes_r, len_q, len_r, freq_q, freq_r, klist,
                   sketchsize64, bbits, random_correct=True, use_rc=True,
                   jaccard=False, chunk=512, post_spec=None, device=None,
                   use_mesh=None, mesh=None):
    """Dense [nq, nr] block, chunked over queries: f32 [nq, nr, 2]
    (core, accessory) or [nq, nr, K] Jaccards; with ``post_spec``
    (ops/fused_assign) also the per-pair classes from the same pass. It
    runs on ``device`` (None: ``_device.resolve``'s choice).

    With more than one card in the default mesh and a big enough block
    (``use_mesh`` None, _auto_mesh's rule), or with ``use_mesh=True``, the
    block is computed sharded over a ('q', 'r') device mesh
    (parallel/dists.py): ``mesh``, or the default mesh over every card."""
    if post_spec is not None and jaccard:
        raise ValueError("post_spec requires (core, accessory) output")
    device = _device.resolve(device)
    if use_mesh is None:
        mesh = mesh or _auto_mesh(device,
                                  planes_q.shape[0] * planes_r.shape[0])
    elif use_mesh:
        if mesh is None:
            from ..parallel.mesh import get_mesh

            mesh = get_mesh()
    else:
        mesh = None
    if mesh is not None:
        from ..parallel.dists import sharded_pairwise_block

        return sharded_pairwise_block(
            mesh, planes_q, planes_r, len_q, len_r, freq_q, freq_r, klist,
            sketchsize64, bbits, random_correct, use_rc, jaccard,
            post_spec=post_spec)
    pad_bits = plane_geometry(sketchsize64, bbits)[2]
    ref = _Operands(planes_r, len_r, freq_r, device, pad_bits)
    qry = _Operands(planes_q, len_q, freq_q, device, pad_bits)
    out = []
    for start in range(0, planes_q.shape[0], chunk):
        o = _dist_chunk(qry.rows(start, start + chunk), ref.rows(0, None),
                        klist, sketchsize64, bbits, random_correct, use_rc,
                        jaccard, post_spec)
        out.append(_to_host(o, post_spec))
    return _concat(out if post_spec is None
                   else ([o[0] for o in out], [o[1] for o in out]))


def _concat(parts):
    """np.concatenate of a list of arrays, or each of a tuple of lists,
    on axis 0, in a dists.concat span counting the output's bytes."""
    with profiling.span("dists.concat") as sp:
        if isinstance(parts, tuple):
            out = tuple(np.concatenate(p, axis=0) for p in parts)
            sp.add(bytes=sum(a.nbytes for a in out))
        else:
            out = np.concatenate(parts, axis=0)
            sp.add(bytes=out.nbytes)
    return out


def _condensed_output(parts, n):
    """The condensed host arrays a chunk's result parts ([rows, cols, ...]
    tensors or arrays) are placed into: n(n-1)/2 rows each, the parts'
    trailing shape and dtype, allocated in a dists.concat span counting
    their bytes."""
    pairs = n * (n - 1) // 2
    with profiling.span("dists.concat") as sp:
        outs = [np.empty((pairs,) + tuple(p.shape[2:]),
                         torch.empty(0, dtype=p.dtype).numpy().dtype
                         if torch.is_tensor(p) else p.dtype)
                for p in parts]
        sp.add(bytes=sum(o.nbytes for o in outs))
    return outs


def _place(outs, blocks, start, stop, n):
    """Write a chunk's condensed rows into place: block row ``local`` is
    genome start + local against genomes start..n-1, and its pairs with
    the later genomes are condensed row start + local, which follows the
    previous row in ``outs``."""
    at = start * n - start * (start + 1) // 2
    with profiling.span("dists.slice"):
        for local in range(stop - start):
            m = n - 1 - start - local
            for out, block in zip(outs, blocks):
                out[at:at + m] = block[local, local + 1:]
            at += m


def _staging(nbytes, count, pinned=True):
    """``count`` host buffers of ``nbytes`` each, page-locked unless
    ``pinned`` is false."""
    return [torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
            for _ in range(count)]


def _staged_copy(buffer, parts):
    """Enqueue the copy of a chunk's result ``parts`` into ``buffer``,
    back to back (the distances first: float32, so a post's classes of up
    to 4 bytes each start on their own boundary), and record an event
    after it. Returns the parts' host views and the event."""
    views, at = [], 0
    for t in parts:
        view = buffer[at:at + t.nbytes].view(t.dtype).view(t.shape)
        view.copy_(t, non_blocking=True)
        views.append(view.numpy())
        at += t.nbytes
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(parts[0].device))
    return views, event


def _land(outs, fetched, n):
    """Wait for a chunk's copy alone (its event, not the stream), then
    place its rows; on the CPU there is nothing to wait for."""
    views, event, start, stop = fetched
    with profiling.span("dists.fetch_wait") as sp:
        if event is None:
            sp.add(ready=1)
        else:
            if profiling.recording():
                sp.add(ready=int(event.query()))
            event.synchronize()
    _place(outs, views, start, stop, n)


def condensed_self_block(planes, lengths, freqs, klist, sketchsize64, bbits,
                         random_correct=True, use_rc=True, jaccard=False,
                         chunk=512, post_spec=None, device=None):
    """Condensed i<j all-vs-all rows without the n x n square: each query
    chunk is compared only with the genomes from its own first row on,
    and its upper-triangle rows are written straight into their span of
    the condensed output, allocated once, at the first chunk. It runs on
    ``device`` (None: ``_device.resolve``'s choice); a chunk of n x chunk
    pairs or more is sharded over the default mesh by pairwise_block's
    rule (_auto_mesh), a smaller one never. The sharded chunks run against
    every genome, whose shards are placed on the mesh once for the pass
    (re-placing them per chunk would move n planes per chunk), and their
    host rows are placed at once.

    On a card each chunk's result is copied, without waiting, into one of
    two reused page-locked buffers, taken at the first chunk computed
    there, which is the largest (a later chunk has fewer columns, or is
    the ragged last), and an event is recorded after the copy; the host
    then waits for the previous such chunk's event and places its rows
    while the card computes and copies this chunk. The chunk two before,
    which used the same buffer, was placed before this chunk's copy was
    enqueued. The caching allocator may hand a result's memory to the
    next chunk at once: its kernels queue behind the copy on the same
    stream. On the CPU a chunk's rows are placed as they are."""
    device = _device.resolve(device)
    pad_bits = plane_geometry(sketchsize64, bbits)[2]
    ops = None  # on the device at the first chunk the mesh does not take
    refs = None  # on the mesh at the first chunk it takes
    n = planes.shape[0]
    if n < 1:
        raise ValueError("condensed_self_block needs at least one genome")
    outs = buffers = pending = None
    staged = 0
    with profiling.span("dists.condensed_self_block"):
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            mesh = _auto_mesh(device, n * (stop - start))
            if mesh is not None:
                from ..parallel.dists import (ShardedReferences,
                                              sharded_pairwise_block)

                if refs is None:
                    refs = ShardedReferences(mesh, planes, lengths, freqs,
                                             pad_bits)
                o = sharded_pairwise_block(
                    mesh, planes[start:stop], planes, lengths[start:stop],
                    lengths, freqs[start:stop], freqs, klist, sketchsize64,
                    bbits, random_correct, use_rc, jaccard, q_chunk=chunk,
                    post_spec=post_spec, refs=refs)
                # columns from the chunk's first genome on, as the single
                # route
                blocks = [a[:, start:] for a in
                          (o if post_spec is not None else (o,))]
                if outs is None:
                    outs = _condensed_output(blocks, n)
                _place(outs, blocks, start, stop, n)
                continue
            if ops is None:
                ops = _Operands(planes, lengths, freqs, device, pad_bits)
            o = _dist_chunk(ops.rows(start, stop), ops.rows(start, n), klist,
                            sketchsize64, bbits, random_correct, use_rc,
                            jaccard, post_spec)
            parts = (o,) if post_spec is None else o
            if outs is None:
                outs = _condensed_output(parts, n)
            nbytes = sum(t.nbytes for t in parts)
            if device.type != "cuda":
                with profiling.span("dists.fetch_copy", bytes=nbytes):
                    views = [t.numpy() for t in parts]
                _land(outs, (views, None, start, stop), n)
                continue
            if buffers is None:
                buffers = _staging(nbytes, min(2, -(-(n - start) // chunk)))
            with profiling.span("dists.fetch_copy", bytes=nbytes):
                views, event = _staged_copy(buffers[staged % 2], parts)
            del o, parts  # the next chunk may take their device memory
            staged += 1
            if pending is not None:
                _land(outs, pending, n)
            pending = (views, event, start, stop)
        if pending is not None:
            _land(outs, pending, n)
    return outs[0] if post_spec is None else tuple(outs)


def warmup_query_programs(sketches_r, klist, post_spec=None, chunk=512,
                          use_rc=True, device=None):
    """Run every query-batch bucket once against a reference set before
    taking traffic. Query batches are padded to powers of two up to
    ``chunk``, so these are all the shapes a serving process meets: the
    kernels are built and the allocator holds each bucket's buffers.
    ``post_spec`` is the model's fused classifier (None for a lineage
    model). Returns the number of buckets warmed."""
    device = _device.resolve(device)
    ss64 = sketches_r[0].sketchsize64
    bbits = sketches_r[0].bbits
    _, wp, pad_bits = plane_geometry(ss64, bbits)
    ref = _Operands(*pack_planes(sketches_r, klist), device, pad_bits)
    n = 0
    bucket = 1
    while True:
        qry = _Operands(np.zeros((bucket, len(klist), bbits, wp), np.uint32),
                        np.ones(bucket, np.int32),
                        np.zeros((bucket, 4), np.float32), device, pad_bits)
        _to_host(_dist_chunk(qry.rows(0, None), ref.rows(0, None), klist,
                             ss64, bbits, True, use_rc, False, post_spec),
                 post_spec)
        n += 1
        if bucket >= chunk:
            return n
        bucket *= 2


def query_db(sketches_r, sketches_q, klist, random_correct=True, use_rc=True,
             jaccard=False, self_mode=False, post_spec=None, device=None):
    """Long-form distances in the reference's row order.

    self_mode: condensed i<j rows over sketches_r (sketches_q ignored);
    otherwise row = q * n_ref + r. Returns float32 [n_rows, 2] (core,
    accessory) or [n_rows, K] Jaccards; with ``post_spec`` also the
    classes [n_rows] from the same pass."""
    ss64 = sketches_r[0].sketchsize64
    bbits = sketches_r[0].bbits
    planes_r, len_r, freq_r = pack_planes(sketches_r, klist)
    if self_mode:
        return condensed_self_block(
            planes_r, len_r, freq_r, klist, ss64, bbits, random_correct,
            use_rc, jaccard, post_spec=post_spec, device=device)
    planes_q, len_q, freq_q = pack_planes(sketches_q, klist)
    block = pairwise_block(planes_q, planes_r, len_q, len_r, freq_q, freq_r,
                           klist, ss64, bbits, random_correct, use_rc,
                           jaccard, post_spec=post_spec, device=device)
    if post_spec is not None:
        block, extra = block
        return block.reshape(-1, block.shape[-1]), extra.reshape(-1)
    return block.reshape(-1, block.shape[-1])
