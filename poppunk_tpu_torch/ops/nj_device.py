"""Neighbour joining on the card.

Counterpart of poppunk_tpu/ops/nj_device.py. The reference shells out to
the external rapidnj binary for large trees (PopPUNK/trees.py:31-72);
here the O(n^3) NJ main loop runs as torch ops on the device: the distance
matrix stays resident, every step evaluates the full masked Q matrix and
takes its first minimum in row-major order (``torch.argmin`` of the
flattened matrix, as ``jnp.argmin``), and records the join in device
tensors. The host fetches the join log once, at the end, and replays it
into a tree.

Agreement with the host float64 NJ is asserted via patristic distance
matrices (topologically identical trees up to rotation).
"""

import numpy as np
import torch

from .. import _device

_INF = 3.4e38  # the masked entries of Q, as the reference's float32 sentinel


def _nj_joins(D):
    """Join log for NJ over an [n, n] float32 distance tensor.

    Returns ((i, j, li, lj) device tensors of length n-2, the two last
    active slots, the final pair distance). Slot j is deactivated at each
    step; slot i holds the new internal node. The loop issues device work
    only: nothing is read back until the caller fetches the log."""
    n = D.shape[0]
    device = D.device
    D = D.clone()
    flat_d = D.view(-1)
    active = torch.ones(n, dtype=torch.bool, device=device)
    amask = torch.ones(n, dtype=torch.float32, device=device)
    log = torch.empty((4, n - 2), dtype=torch.float32, device=device)
    for step in range(n - 2):
        m = float(n - step)
        # row sums over active columns: for an active row, the reference's
        # (D * pair_mask).sum(axis=1); inactive rows are masked out of Q
        r = D @ amask
        Q = (m - 2.0) * D - r[:, None] - r[None, :]
        Q.masked_fill_(~(active[:, None] & active[None, :]), _INF)
        Q.diagonal().fill_(_INF)
        flat = torch.argmin(Q)
        i, j = flat // n, flat % n
        i, j = torch.minimum(i, j), torch.maximum(i, j)
        dij = flat_d[i * n + j]
        li = 0.5 * dij + (r[i] - r[j]) / (2.0 * (m - 2.0))
        lj = dij - li
        new_row = 0.5 * (D[i] + D[j] - dij)
        D.index_copy_(0, i.view(1), new_row[None, :])
        D.index_copy_(1, i.view(1), new_row[:, None])
        flat_d.index_fill_(0, (i * (n + 1)).view(1), 0.0)
        active.index_fill_(0, j.view(1), False)
        amask.index_fill_(0, j.view(1), 0.0)
        log[:, step] = torch.stack([i.float(), j.float(), li.clamp(min=0.0),
                                    lj.clamp(min=0.0)])
    # distance between the last two active slots
    last_slots = torch.nonzero(active)[:, 0]
    a, b = last_slots[0], last_slots[1]
    last_d = 0.5 * (D[a, b] + D[b, a])
    return log, last_slots, last_d


def neighbor_joining_device(D, labels, device=None):
    """Device twin of trees.neighbor_joining, on ``device`` (None:
    ``_device.resolve``'s choice); returns the same Node tree type (joined
    on the host from the device join log)."""
    from ..trees import Node

    device = _device.resolve(device)
    n = D.shape[0]
    if n < 3:
        from ..trees import neighbor_joining

        return neighbor_joining(D, labels)
    log, last_slots, last_d = _nj_joins(torch.as_tensor(
        np.asarray(D, dtype=np.float32), device=device))
    log = log.cpu().numpy()
    i_arr, j_arr = log[0].astype(np.int64), log[1].astype(np.int64)
    li_arr, lj_arr = log[2], log[3]
    last_slots = last_slots.cpu().numpy()
    last_d = float(last_d)

    nodes = [Node(lab) for lab in labels]
    for i, j, li, lj in zip(i_arr, j_arr, li_arr, lj_arr):
        parent = Node()
        nodes[i].edge_length = float(li)
        nodes[j].edge_length = float(lj)
        parent.add_child(nodes[i])
        parent.add_child(nodes[j])
        nodes[i] = parent

    a, b = int(last_slots[0]), int(last_slots[1])
    root = Node()
    nodes[a].edge_length = last_d / 2
    nodes[b].edge_length = last_d / 2
    root.add_child(nodes[a])
    root.add_child(nodes[b])
    return root


# Below this size the host numpy loop beats device dispatch overhead.
DEVICE_NJ_MIN_N = 512


def use_device_nj(n, device=None):
    """The reference's routing: NJ on the device from DEVICE_NJ_MIN_N
    genomes when the device (None: ``_device.resolve``'s choice) is the
    card; the host float64 NJ otherwise."""
    return n >= DEVICE_NJ_MIN_N and _device.resolve(device).type == "cuda"
