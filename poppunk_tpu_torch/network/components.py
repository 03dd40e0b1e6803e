"""Connected components on the host.

Counterpart of the host path of poppunk_tpu/network/components.py
(graph-tool's label_components in PopPUNK/network.py:1538): the native
union-find of native/graph_core.cpp (labels bit-equal to scipy's, O(n + m)
memory), with scipy.sparse.csgraph as the fallback when the library cannot
be built or loaded. The reference's device label propagation is not on
this package's path yet.
"""

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph


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
