"""Host network code, copied from poppunk_tpu/network/graph.py (that
package loads jax on import); its imports point at this package.

Array-native undirected graph.

The reference builds graph-tool (C++/Boost) or cugraph objects
(PopPUNK/network.py:734-864); here a graph is just arrays — n_vertices plus
an edge list (and optional weights) — which the scipy host algorithms
consume directly.

Storage format: ``.graph.npz`` (numpy archive with n_vertices, edges,
weights), the JAX package's own. PopPUNK's graph-tool ``.gt`` and cugraph
``.csv.gz`` networks load too (read only). GraphML export/import is
provided for interop with the reference's ``--cytoscape``/graphml outputs.
"""

import os
import xml.etree.ElementTree as ET
import xml.sax.saxutils

import numpy as np
import scipy.sparse


class Graph:
    def __init__(self, n_vertices, edges=None, weights=None):
        self.n_vertices = int(n_vertices)
        if edges is None:
            edges = np.zeros((0, 2), dtype=np.int64)
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.edges = edges
        self.weights = None if weights is None else np.asarray(weights, dtype=np.float64)
        if self.weights is not None and self.weights.shape[0] != edges.shape[0]:
            raise ValueError("weights length != edge count")

    # -- construction ------------------------------------------------------
    def add_edges(self, edges, weights=None):
        """Return a new Graph with the edges appended."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        new_edges = np.concatenate([self.edges, edges])
        if self.weights is not None or weights is not None:
            old_w = self.weights if self.weights is not None else np.zeros(len(self.edges))
            add_w = (
                np.asarray(weights, dtype=np.float64)
                if weights is not None
                else np.zeros(len(edges))
            )
            new_w = np.concatenate([old_w, add_w])
        else:
            new_w = None
        return Graph(self.n_vertices, new_edges, new_w)

    # -- views -------------------------------------------------------------
    @property
    def n_edges(self):
        return self.edges.shape[0]

    def adjacency(self, weights=False, nodes=None):
        """Symmetric CSR adjacency. With ``nodes``, restrict to that vertex
        subset (keeping original indexing)."""
        e = self.edges
        if nodes is not None:
            mask = np.zeros(self.n_vertices, dtype=bool)
            mask[nodes] = True
            keep = mask[e[:, 0]] & mask[e[:, 1]]
            e = e[keep]
            w = self.weights[keep] if (weights and self.weights is not None) else None
        else:
            w = self.weights if weights else None
        data = w if w is not None else np.ones(e.shape[0], dtype=np.float64)
        mat = scipy.sparse.coo_matrix(
            (np.concatenate([data, data]),
             (np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]]))),
            shape=(self.n_vertices, self.n_vertices),
        )
        if w is None:
            # boolean structure: collapse duplicates
            mat.data[:] = 1.0
            mat = mat.tocsr()
            mat.data[:] = 1.0
            return mat
        return mat.tocsr()

    def degrees(self, nodes=None):
        e = self.edges
        if nodes is not None:
            mask = np.zeros(self.n_vertices, dtype=bool)
            mask[nodes] = True
            e = e[mask[e[:, 0]] & mask[e[:, 1]]]
        deg = np.bincount(e[:, 0], minlength=self.n_vertices) + np.bincount(
            e[:, 1], minlength=self.n_vertices
        )
        return deg

    def subgraph(self, vertices, relabel=True):
        """Induced subgraph on ``vertices``.

        relabel=True renumbers vertices 0..len-1 in the order given (the
        reference's gt.Graph(GraphView, prune=True) behaviour); returns
        (graph, old_vertex_ids).
        """
        vertices = np.asarray(vertices, dtype=np.int64)
        mask = np.zeros(self.n_vertices, dtype=bool)
        mask[vertices] = True
        keep = mask[self.edges[:, 0]] & mask[self.edges[:, 1]]
        e = self.edges[keep]
        w = self.weights[keep] if self.weights is not None else None
        if not relabel:
            return Graph(self.n_vertices, e, w), np.arange(self.n_vertices)
        lookup = np.full(self.n_vertices, -1, dtype=np.int64)
        lookup[vertices] = np.arange(vertices.shape[0])
        return Graph(vertices.shape[0], lookup[e], w), vertices

    # -- persistence -------------------------------------------------------
    def save(self, path):
        """Native .graph.npz format."""
        payload = {"n_vertices": np.int64(self.n_vertices), "edges": self.edges}
        if self.weights is not None:
            payload["weights"] = self.weights
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path):
        with np.load(path) as data:
            return cls(
                int(data["n_vertices"]),
                data["edges"],
                data["weights"] if "weights" in data else None,
            )

    @classmethod
    def load_csv_gz(cls, path):
        """Read a cugraph-written edge list (PopPUNK/network.py:138-146).
        Accepts both src/dst and source/destination headers; vertices are
        the implied 0..max range (the CSV records no isolated vertices —
        the reference has the same property)."""
        import csv
        import gzip

        with gzip.open(path, "rt") as f:
            reader = csv.DictReader(f)
            cols = {c.lower(): c for c in reader.fieldnames}
            s = cols.get("source", cols.get("src"))
            d = cols.get("destination", cols.get("dst"))
            w = cols.get("weights", cols.get("weight"))
            if s is None or d is None:
                raise ValueError(f"{path}: no source/destination columns")
            edges, weights = [], []
            for row in reader:
                edges.append((int(row[s]), int(row[d])))
                if w is not None:
                    weights.append(float(row[w]))
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        n = int(edges.max()) + 1 if edges.size else 0
        return cls(n, edges,
                   np.asarray(weights) if w is not None else None)

    @classmethod
    def load_gt(cls, path):
        """Load a graph-tool .gt file (e.g. a published PopPUNK
        database's _graph.gt, PopPUNK/network.py:120-176)."""
        from .gt_format import read_gt

        n, edges, directed, props = read_gt(path)
        if directed:
            raise ValueError(
                f"{path} stores a directed graph; PopPUNK networks are "
                "undirected and directed .gt files are not supported")
        weights = None
        for (key_type, name), values in props.items():
            if key_type == 2 and name == "weight":
                # copy: frombuffer views pin the whole file's bytes and
                # are read-only
                weights = np.array(values, dtype=np.float64)
        return cls(n, edges, weights)

    def save_graphml(self, path, vertex_labels=None):
        """GraphML export (interop with the reference's graphml outputs)."""
        esc = xml.sax.saxutils.escape
        with open(path, "w") as f:
            f.write('<?xml version="1.0" encoding="UTF-8"?>\n')
            f.write(
                '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">\n'
            )
            f.write('  <key id="d0" for="node" attr.name="id" attr.type="string"/>\n')
            if self.weights is not None:
                f.write('  <key id="d1" for="edge" attr.name="weight" attr.type="double"/>\n')
            f.write('  <graph id="G" edgedefault="undirected">\n')
            for v in range(self.n_vertices):
                label = vertex_labels[v] if vertex_labels is not None else str(v)
                f.write(f'    <node id="n{v}"><data key="d0">{esc(label)}</data></node>\n')
            for idx, (s, t) in enumerate(self.edges):
                if self.weights is not None:
                    f.write(
                        f'    <edge source="n{s}" target="n{t}">'
                        f'<data key="d1">{self.weights[idx]}</data></edge>\n'
                    )
                else:
                    f.write(f'    <edge source="n{s}" target="n{t}"/>\n')
            f.write("  </graph>\n</graphml>\n")

    @classmethod
    def load_graphml(cls, path):
        ns = {"g": "http://graphml.graphdrawing.org/xmlns"}
        tree = ET.parse(path)
        root = tree.getroot()
        graph = root.find("g:graph", ns)
        node_ids = {}
        labels = []
        for node in graph.findall("g:node", ns):
            node_ids[node.get("id")] = len(node_ids)
            data = node.find("g:data", ns)
            labels.append(data.text if data is not None else node.get("id"))
        edges = []
        weights = []
        has_w = False
        for edge in graph.findall("g:edge", ns):
            edges.append((node_ids[edge.get("source")], node_ids[edge.get("target")]))
            data = edge.find("g:data", ns)
            if data is not None:
                has_w = True
                weights.append(float(data.text))
            else:
                weights.append(0.0)
        g = cls(len(node_ids), np.array(edges, dtype=np.int64).reshape(-1, 2),
                np.array(weights) if has_w else None)
        g.vertex_labels = labels
        return g


GRAPH_SUFFIX = ".graph.npz"


def save_network(G, prefix=None, suffix=None, use_graphml=False,
                 vertex_labels=None):
    """Save with the reference's naming convention
    (PopPUNK/network.py:1855-1884): ``<prefix>/<basename><suffix>``."""
    file_name = os.path.join(prefix, os.path.basename(prefix))
    if suffix is not None:
        file_name += suffix
    os.makedirs(prefix, exist_ok=True)
    if use_graphml:
        G.save_graphml(file_name + ".graphml", vertex_labels)
        return file_name + ".graphml"
    G.save(file_name + GRAPH_SUFFIX)
    return file_name + GRAPH_SUFFIX


def load_network_file(fn):
    if fn.endswith(".graphml"):
        return Graph.load_graphml(fn)
    if fn.endswith(".gt"):
        return Graph.load_gt(fn)
    if fn.endswith(".csv.gz"):
        return Graph.load_csv_gz(fn)
    return Graph.load(fn)


def remove_nodes_from_graph(G, reflist, samples_to_keep):
    """Induced subgraph keeping only the named samples
    (PopPUNK/network.py:1988-2027).

    Indices beyond the graph's vertex count are ignored — prune_graph
    passes the full database name list even to `.refs_graph` files whose
    vertex set is the reference subset (the reference's graph-tool
    filtering is equally lenient, and its loop saves the correctly-pruned
    `_graph` last)."""
    keep_set = frozenset(samples_to_keep)
    vertices = np.array(
        [i for i, name in enumerate(reflist)
         if name in keep_set and i < G.n_vertices],
        dtype=np.int64,
    )
    G_new, _ = G.subgraph(vertices, relabel=True)
    return G_new


def prune_graph(prefix, reflist, samples_to_keep, output_db_name):
    """Prune every network artefact found under prefix to the kept samples
    (PopPUNK/network.py:1948-1986)."""
    import sys

    network_found = False
    for graph_name in (
        "_core.refs_graph", "_core_graph", "_accessory.refs_graph",
        "_accessory_graph", ".refs_graph", "_graph",
    ):
        network_fn = os.path.join(
            prefix, os.path.basename(prefix) + graph_name + GRAPH_SUFFIX
        )
        if os.path.exists(network_fn):
            network_found = True
            sys.stderr.write("Loading network from " + network_fn + "\n")
            G = load_network_file(network_fn)
            G_new = remove_nodes_from_graph(G, reflist, samples_to_keep)
            save_network(G_new, prefix=output_db_name, suffix="_graph")
    if not network_found:
        sys.stderr.write("No network file found for pruning\n")


def remove_non_query_components(G, rlist, qlist, relabel=False):
    """Keep only components containing at least one query
    (PopPUNK/network.py:2029-2073). Returns (subgraph, pruned_names).

    relabel=False preserves vertex ids (the reference's GraphView
    semantics); relabel=True renumbers kept vertices 0..K-1 in
    pruned_names order (a compact standalone artefact whose vertex i is
    pruned_names[i] — what the partial-query-graph file stores)."""
    from .components import connected_components

    combined_names = list(rlist) + list(qlist)
    labels, _ = connected_components(G)
    components_with_query = set(labels[len(rlist):].tolist())
    keep_mask = np.isin(labels, list(components_with_query))
    pruned_names = [combined_names[i] for i in np.where(keep_mask)[0]]
    keep_vertices = np.where(keep_mask)[0]
    G_sub, _ = G.subgraph(keep_vertices, relabel=relabel)
    return G_sub, pruned_names
