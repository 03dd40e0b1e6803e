"""Incremental network scoring for the refine boundary sweep, and the
ctypes bindings of the shared native graph core (native/graph_core.cpp).

Copied from poppunk_tpu/network/incremental.py (that package loads jax on
import): the native sparse sweep scorer, union-find components and Brandes
betweenness, plus the pure-Python ``IncrementalNetwork`` that
``grow_network_scores`` falls back to and that writes the per-boundary
cluster files of ``--multi-boundary``. The library is the repository's own
``native/libgraph_core.so``, built from ``native/graph_core.cpp`` with g++
on first use; both packages load the same file.

The reference's growNetwork (PopPUNK/refine.py:375-474) rebuilds and
re-summarises the graph after each batch of added edges; here the sweep is
scored incrementally: union-find components with size tracking, running
wedge / triangle counts over adjacency sets, Brandes betweenness recomputed
per offset only for score_idx > 0.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

from .graph import Graph
from .summary import betweenness_max_per_component

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgraph_core.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "graph_core.cpp")
_graph_lib = None
_graph_lib_tried = False


def _get_graph_lib():
    """The native graph core (built on first use; None if unavailable)."""
    global _graph_lib, _graph_lib_tried
    if _graph_lib is not None or _graph_lib_tried:
        return _graph_lib
    _graph_lib_tried = True
    try:
        if (not os.path.isfile(_LIB_PATH) or
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
            cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                   "-fPIC", "-o", _LIB_PATH, _SRC_PATH]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except subprocess.CalledProcessError:
                # toolchains without OpenMP still get the serial build
                cmd.remove("-fopenmp")
                subprocess.run(cmd, check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.sweep_scores_v2.restype = None
        lib.sweep_scores_v2.argtypes = [
            i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, f64p,
        ]
        lib.brandes_native.restype = None
        lib.brandes_native.argtypes = [
            ctypes.POINTER(ctypes.c_int64), i32p, ctypes.c_int32, i32p,
            ctypes.c_int64, f64p,
        ]
        lib.connected_components_native.restype = ctypes.c_int32
        lib.connected_components_native.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p,
        ]
        _graph_lib = lib
    except Exception as e:  # noqa: BLE001 — callers fall back to scipy
        sys.stderr.write(f"Native graph core unavailable ({e})\n")
        _graph_lib = None
    return _graph_lib


def sweep_scores_native(n_vertices, i_vec, j_vec, idx_vec, n_offsets,
                        score_idx=0, betweenness_sample=100, seed=0):
    """-(score) per offset via the C++ sparse sweep (any score_idx), or
    None if the native library is unavailable."""
    lib = _get_graph_lib()
    if lib is None:
        return None
    i_vec = np.ascontiguousarray(i_vec, dtype=np.int32)
    j_vec = np.ascontiguousarray(j_vec, dtype=np.int32)
    idx_vec = np.ascontiguousarray(idx_vec, dtype=np.int32)
    out = np.empty(n_offsets, dtype=np.float64)
    lib.sweep_scores_v2(
        i_vec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        j_vec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx_vec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(i_vec.shape[0]), ctypes.c_int32(int(n_vertices)),
        ctypes.c_int32(int(n_offsets)), ctypes.c_int32(int(score_idx)),
        ctypes.c_int32(int(betweenness_sample)), ctypes.c_uint64(int(seed)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def components_native(n_vertices, i_vec, j_vec):
    """(labels int32[n], sizes) via the C++ union-find; labels follow the
    scipy first-occurrence convention. None if the lib is unavailable."""
    lib = _get_graph_lib()
    if lib is None:
        return None
    # the C++ union-find indexes parent[] unchecked: validate before the
    # int32 cast, so bad edges raise as on the scipy path
    i_vec = np.asarray(i_vec)
    j_vec = np.asarray(j_vec)
    if len(i_vec) and (min(i_vec.min(), j_vec.min()) < 0
                       or max(i_vec.max(), j_vec.max()) >= n_vertices):
        raise IndexError("edge endpoint out of range "
                         f"[0, {int(n_vertices)})")
    i_vec = np.ascontiguousarray(i_vec, dtype=np.int32)
    j_vec = np.ascontiguousarray(j_vec, dtype=np.int32)
    labels = np.empty(int(n_vertices), dtype=np.int32)
    n_comp = lib.connected_components_native(
        i_vec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        j_vec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(i_vec.shape[0]), ctypes.c_int32(int(n_vertices)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, np.bincount(labels, minlength=int(n_comp))


def brandes_native(A, sources):
    """Native Brandes betweenness over a CSR adjacency from the given
    sources, or None if the native library is unavailable."""
    lib = _get_graph_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    sources = np.ascontiguousarray(sources, dtype=np.int32)
    out = np.empty(A.shape[0], dtype=np.float64)
    lib.brandes_native(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(int(A.shape[0])),
        sources.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(sources.shape[0]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


class IncrementalNetwork:
    def __init__(self, n_vertices):
        self.n = n_vertices
        self.parent = np.arange(n_vertices, dtype=np.int64)
        self.size = np.ones(n_vertices, dtype=np.int64)
        self.n_components = n_vertices
        self.adj = [set() for _ in range(n_vertices)]
        self.n_edges = 0
        self.wedges = 0  # sum deg*(deg-1)/2
        self.triangles = 0

    def _find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def add_edge(self, u, v):
        u = int(u)
        v = int(v)
        if u == v or v in self.adj[u]:
            return
        # components
        ru, rv = self._find(u), self._find(v)
        if ru != rv:
            if self.size[ru] < self.size[rv]:
                ru, rv = rv, ru
            self.parent[rv] = ru
            self.size[ru] += self.size[rv]
            self.n_components -= 1
        # clustering counts
        self.wedges += len(self.adj[u]) + len(self.adj[v])
        small, large = ((self.adj[u], self.adj[v])
                        if len(self.adj[u]) < len(self.adj[v])
                        else (self.adj[v], self.adj[u]))
        self.triangles += sum(1 for x in small if x in large)
        self.adj[u].add(v)
        self.adj[v].add(u)
        self.n_edges += 1

    def add_edges(self, us, vs):
        for u, v in zip(us, vs):
            self.add_edge(u, v)

    def metrics(self):
        density = (self.n_edges / (0.5 * self.n * (self.n - 1))
                   if self.n > 1 else 0.0)
        transitivity = (
            3.0 * self.triangles / self.wedges if self.wedges > 0 else 0.0
        )
        return self.n_components, density, transitivity

    def to_graph(self):
        edges = [(u, v) for u in range(self.n) for v in self.adj[u] if v > u]
        return Graph(self.n, np.array(edges, dtype=np.int64).reshape(-1, 2))

    def component_labels(self):
        return np.array([self._find(v) for v in range(self.n)],
                        dtype=np.int64)

    def score(self, score_idx=0, betweenness_sample=100, rng=None):
        """Network score as in networkSummary (network.py:1303-1307)."""
        comps, density, transitivity = self.metrics()
        base = transitivity * (1.0 - density)
        if score_idx == 0:
            return base
        G = self.to_graph()
        labels = self.component_labels()
        uniq, labels = np.unique(labels, return_inverse=True)
        sizes = np.bincount(labels)
        maxima, comp_sizes = betweenness_max_per_component(
            G, labels, sizes, sample_sources=betweenness_sample, rng=rng
        )
        if len(maxima) > 1:
            mean_bt = float(np.mean(maxima))
            wmean_bt = float(np.average(maxima, weights=comp_sizes))
        elif len(maxima) == 1:
            mean_bt = wmean_bt = float(maxima[0])
        else:
            mean_bt = wmean_bt = 0.0
        return base * (1.0 - (mean_bt if score_idx == 1 else wmean_bt))


def grow_network_scores(n_vertices, i_vec, j_vec, idx_vec, n_offsets,
                        score_idx=0, betweenness_sample=100,
                        write_clusters=None, sample_names=None, rng=None):
    """Score the network at every sweep offset (growNetwork equivalent,
    PopPUNK/refine.py:375-474). Returns -score per offset.

    With ``write_clusters`` set to an output prefix, clusters are written at
    each offset having at least one non-trivial cluster (multi_refine path).
    """
    from .clusters import print_clusters

    if not write_clusters and len(i_vec) > 0:
        # sampled-source draws differ between the native mt19937 and the
        # numpy rng, but components <= betweenness_sample are scored from
        # all sources in both paths (exact equality: the tested regime)
        seed = 0 if rng is None else int(rng.integers(2**63))
        native = sweep_scores_native(n_vertices, i_vec, j_vec, idx_vec,
                                     n_offsets, score_idx=score_idx,
                                     betweenness_sample=betweenness_sample,
                                     seed=seed)
        if native is not None:
            return native

    net = IncrementalNetwork(n_vertices)
    scores = np.ones(n_offsets)
    order = np.argsort(idx_vec, kind="stable")
    i_vec = np.asarray(i_vec)[order]
    j_vec = np.asarray(j_vec)[order]
    idx_vec = np.asarray(idx_vec)[order]
    pos = 0
    for off in range(n_offsets):
        end = pos
        while end < idx_vec.shape[0] and idx_vec[end] <= off:
            end += 1
        net.add_edges(i_vec[pos:end], j_vec[pos:end])
        pos = end
        s = net.score(score_idx, betweenness_sample, rng=rng)
        scores[off] = -s
        if write_clusters and net.n_components < n_vertices:
            o_prefix = os.path.join(
                write_clusters,
                os.path.basename(write_clusters) + f"_boundary{off + 1}",
            )
            print_clusters(
                net.to_graph(), sample_names, out_prefix=o_prefix,
                write_unwords=False,
            )
    return scores
