"""Connected components: the host path and min-label propagation on a
device.

Counterpart of poppunk_tpu/network/components.py (graph-tool's
label_components in PopPUNK/network.py:1538). The host path is the native
union-find of native/graph_core.cpp (labels bit-equal to scipy's, O(n + m)
memory), with scipy.sparse.csgraph as the fallback when the library cannot
be built or loaded. The device path propagates the minimum vertex id over
an edge array with ``scatter_reduce_(..., "amin")`` until nothing changes;
its labels are each component's smallest vertex.
"""

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import torch


def connected_components(G):
    """(labels int[n], sizes int64[n_comp]); labels are component ids in
    order of first occurrence (scipy's convention, as graph-tool's)."""
    nat = _native_labels(G.n_vertices, G.edges[:, 0], G.edges[:, 1])
    if nat is not None:
        return nat
    n_comp, labels = scipy.sparse.csgraph.connected_components(
        G.adjacency(), directed=False
    )
    return labels, np.bincount(labels, minlength=n_comp)


def _native_labels(n, i_vec, j_vec):
    from .incremental import components_native

    try:
        return components_native(n, i_vec, j_vec)
    except IndexError:
        raise
    except Exception:  # noqa: BLE001 — any load/ABI failure: scipy path
        return None


def label_prop_step(labels, src, dst, mask):
    """One propagation sweep: both ends of every active edge take the
    smaller of their two labels (scatter-min)."""
    lo = torch.minimum(labels[src], labels[dst])
    lo = torch.where(mask, lo, torch.iinfo(labels.dtype).max)
    labels = labels.clone()
    labels.scatter_reduce_(0, src, lo, reduce="amin")
    labels.scatter_reduce_(0, dst, lo, reduce="amin")
    return labels


def connected_components_device(n, src, dst, mask, max_iters=None):
    """int32 [n] component labels (the smallest vertex id of each
    component) by min-label propagation to a fixed point, on the edges'
    device. src / dst: int64 [E] (padding is fine, masked out); mask:
    bool [E]. Plain propagation needs O(diameter) sweeps; the loop stops
    at the first sweep that changes nothing, or after ``max_iters``
    (default n, the worst case of a path graph)."""
    labels = torch.arange(n, dtype=torch.int32, device=src.device)
    for _ in range(n if max_iters is None else max_iters):
        new = label_prop_step(labels, src, dst, mask)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


def count_components_device(labels):
    """Number of distinct labels (components) of a label vector from
    connected_components_device."""
    roots = labels == torch.arange(labels.shape[0], dtype=labels.dtype,
                                   device=labels.device)
    return int(roots.sum())
