"""Sharded all-vs-all / query-vs-reference distances over a device mesh.

Counterpart of poppunk_tpu/parallel/dists.py: the packed reference planes
are split along the mesh's ``r`` axis, query chunks along ``q``, and every
device computes its (query shard x reference shard) tile with the port's
distance chunk (``ops/distances._dist_chunk``: the match-count kernel of
the current ``KERNEL_CHOICE``, the Jaccard correction, the k-mer fit and
the optional fused post). Reference shards are placed once per call, or
once for many calls (ShardedReferences); each query chunk's tiles are all
enqueued before any is read back, so tiles on distinct cards overlap. The tiles are then gathered on the host in (q, r)
order; under a process group each rank computes the tiles of the devices
it owns and the blocks are exchanged over gloo (``_fetch``).

Works on any mesh, one device included.
"""

import numpy as np
import torch

from ..ops.distances import _dist_chunk, _Operands, plane_geometry
from ..ops.fused_assign import post_spec_on
from .mesh import process_count


def _local_block(qry, ref, klist, sketchsize64, bbits, random_correct,
                 use_rc, jaccard, post_spec):
    """Distance tile for one device's (query shard, reference shard):
    ``qry`` and ``ref`` are _Operands on that device, ``post_spec`` has
    its parameters there. Returns dists, or (dists, classes)."""
    return _dist_chunk(qry.rows(0, None), ref.rows(0, None), klist,
                       sketchsize64, bbits, random_correct, use_rc, jaccard,
                       post_spec)


def _fetch(mesh, tiles, n_q, n_r):
    """{(qi, ri): host tile} -> the global [n_q, n_r, ...] block, every
    process alike. Each rank holds the tiles of the devices it owns; under
    a process group every rank's block (zeros outside its tiles) is
    all-gathered as a host tensor over gloo and each tile is taken from
    its owner, as the reference's process_allgather hands back host
    numpy."""
    some = next(iter(tiles.values()))
    tq, tr = some.shape[:2]
    block = np.zeros((n_q, n_r) + some.shape[2:], some.dtype)
    for (qi, ri), tile in tiles.items():
        block[qi * tq:(qi + 1) * tq, ri * tr:(ri + 1) * tr] = tile
    if process_count() == 1:
        return block
    mine = torch.from_numpy(block)
    blocks = [torch.empty_like(mine) for _ in range(process_count())]
    torch.distributed.all_gather(blocks, mine)
    for qi in range(mesh.shape["q"]):
        for ri in range(mesh.shape["r"]):
            owner = blocks[int(mesh.ranks[qi, ri])].numpy()
            sl = (slice(qi * tq, (qi + 1) * tq),
                  slice(ri * tr, (ri + 1) * tr))
            block[sl] = owner[sl]
    return block


def _pad_axis0(arrs, n_to):
    out = []
    for a in arrs:
        pad = n_to - a.shape[0]
        if pad:
            a = np.pad(np.asarray(a), ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        out.append(a)
    return out


class ShardedReferences:
    """A reference set padded with zero genomes to a multiple of the mesh's
    ``r`` and placed on it: shard ri on the devices of column ri, once per
    (device, shard) (a virtual mesh's repeated device shares it). Built
    once, it serves every block against the same references
    (condensed_self_block's chunks) without placing them again."""

    def __init__(self, mesh, planes_r, len_r, freq_r, pad_bits):
        self.n = planes_r.shape[0]
        r_size = mesh.shape["r"]
        self.n_pad = ((self.n + r_size - 1) // r_size) * r_size
        planes_r, len_r, freq_r = _pad_axis0(
            [planes_r, np.asarray(len_r),
             np.asarray(freq_r, dtype=np.float32)], self.n_pad)
        r_loc = self.n_pad // r_size
        self.ops = {}
        for _, ri, dev in mesh.tiles():
            if (dev, ri) not in self.ops:
                sl = slice(ri * r_loc, (ri + 1) * r_loc)
                self.ops[dev, ri] = _Operands(planes_r[sl], len_r[sl],
                                              freq_r[sl], dev, pad_bits)


def sharded_pairwise_block(mesh, planes_q, planes_r, len_q, len_r, freq_q,
                           freq_r, klist, sketchsize64, bbits,
                           random_correct=True, use_rc=True, jaccard=False,
                           q_chunk=1024, post_spec=None, refs=None):
    """Dense [nq, nr, 2] block (or [nq, nr, K] Jaccards), sharded over the
    mesh; host numpy in, host numpy out.

    Queries are processed in host-side chunks of ``q_chunk`` per q-shard
    to bound device memory for huge all-vs-all runs, each chunk bucketed
    to a power of two and then a multiple of ``q``; references are padded
    with zero genomes to a multiple of ``r``, and the pads are sliced off.
    ``refs``: the references already placed on this mesh
    (ShardedReferences of planes_r, len_r, freq_r); None places them here.
    With ``post_spec`` (ops/fused_assign) returns (dists, classes[nq, nr]):
    each device classifies its own tile."""
    if post_spec is not None and jaccard:
        raise ValueError("post_spec requires (core, accessory) output")
    _, _, pad_bits = plane_geometry(sketchsize64, bbits)
    q_size = mesh.shape["q"]
    klist = tuple(int(k) for k in klist)
    if refs is None:
        refs = ShardedReferences(mesh, planes_r, len_r, freq_r, pad_bits)
    nq, nr, nr_p = planes_q.shape[0], refs.n, refs.n_pad

    # the post's parameters on every device, once
    tiles = mesh.tiles()
    posts = {}
    if post_spec is not None:
        for _, _, dev in tiles:
            if dev not in posts:
                posts[dev] = post_spec_on(post_spec, dev)

    step = q_chunk * q_size
    out, out_extra = [], []
    for start in range(0, nq, step):
        stop = min(start + step, nq)
        # bucket the chunk to a power of two (then a q_size multiple), the
        # reference's program buckets
        bucket = 1
        while bucket < stop - start:
            bucket *= 2
        cq = ((bucket + q_size - 1) // q_size) * q_size
        pq, lq, fq = _pad_axis0(
            [planes_q[start:stop], np.asarray(len_q[start:stop]),
             np.asarray(freq_q[start:stop], dtype=np.float32)], cq)
        q_loc = cq // q_size
        qrys = {}
        for qi, _, dev in tiles:
            if (dev, qi) not in qrys:
                sl = slice(qi * q_loc, (qi + 1) * q_loc)
                qrys[dev, qi] = _Operands(pq[sl], lq[sl], fq[sl], dev,
                                          pad_bits)
        # every owned tile is enqueued before any is read back
        dev_tiles = {
            (qi, ri): _local_block(qrys[dev, qi], refs.ops[dev, ri], klist,
                                   sketchsize64, bbits, random_correct,
                                   use_rc, jaccard, posts.get(dev))
            for qi, ri, dev in tiles}
        if post_spec is not None:
            dists = {k: t[0].cpu().numpy() for k, t in dev_tiles.items()}
            extra = {k: t[1].cpu().numpy() for k, t in dev_tiles.items()}
            out_extra.append(
                _fetch(mesh, extra, cq, nr_p)[:stop - start, :nr])
        else:
            dists = {k: t.cpu().numpy() for k, t in dev_tiles.items()}
        del dev_tiles
        out.append(_fetch(mesh, dists, cq, nr_p)[:stop - start, :nr])
    if post_spec is not None:
        return (np.concatenate(out, axis=0),
                np.concatenate(out_extra, axis=0))
    return np.concatenate(out, axis=0)


def sharded_query_dists(sketches_r, sketches_q, klist, mesh,
                        random_correct=True, use_rc=True, jaccard=False):
    """Long-form query-vs-ref distances, row = q * n_ref + r
    (PopPUNK/assign.py:690 row convention)."""
    from ..ops.distances import pack_planes

    ss64 = sketches_r[0].sketchsize64
    bbits = sketches_r[0].bbits
    planes_r, len_r, freq_r = pack_planes(sketches_r, klist)
    planes_q, len_q, freq_q = pack_planes(sketches_q, klist)
    block = sharded_pairwise_block(
        mesh, planes_q, planes_r, len_q, len_r, freq_q, freq_r, klist,
        ss64, bbits, random_correct, use_rc, jaccard)
    return block.reshape(-1, block.shape[-1])


def sharded_self_dists(sketches, klist, mesh, random_correct=True,
                       use_rc=True, jaccard=False, q_chunk=1024):
    """Condensed i<j all-vs-all distances (PopPUNK/utils.py:199-226 order).

    Streams query chunks and slices each to its upper-triangle rows so the
    full n x n square is never materialised on the host."""
    from ..ops.distances import pack_planes

    ss64 = sketches[0].sketchsize64
    bbits = sketches[0].bbits
    planes, lengths, freqs = pack_planes(sketches, klist)
    n = len(sketches)
    out = []
    for start in range(0, n, q_chunk):
        stop = min(start + q_chunk, n)
        block = sharded_pairwise_block(
            mesh, planes[start:stop], planes, lengths[start:stop], lengths,
            freqs[start:stop], freqs, klist, ss64, bbits, random_correct,
            use_rc, jaccard, q_chunk=q_chunk)
        for local, gi in enumerate(range(start, stop)):
            out.append(block[local, gi + 1:])
    return np.concatenate(out, axis=0)
