"""Phylogenetic trees: neighbour-joining, midpoint rooting, MST conversion.

Re-implements the reference's PopPUNK/trees.py without biopython/treeswift:

- ``generate_nj_tree`` (trees.py:160-196): NJ here is the Studier–Keppler
  O(n^3) formulation vectorised in numpy (the reference delegates to
  Bio.Phylo's pure-Python constructor or the external rapidnj binary;
  rapidnj is still used if a path is given), followed by midpoint rooting.
  From 512 genomes on the card it runs as torch ops (ops/nj_device.py).
- ``mst_to_phylogeny`` (trees.py:199-264): BFS from the highest-degree
  seed; internal MST nodes get zero-length leaf duplicates so every sample
  appears as a leaf.
- ``write_tree`` / ``load_tree`` / newick emission (trees.py:95-158).

Copied from ``poppunk_tpu/trees.py``, whose counterpart it is: this
package imports nothing of the JAX package. Only ``generate_nj_tree``
differs: it takes the device the NJ runs on.
"""

import os
import subprocess
import sys

import numpy as np


class Node:
    __slots__ = ("label", "children", "edge_length")

    def __init__(self, label=None, edge_length=None):
        self.label = label
        self.children = []
        self.edge_length = edge_length

    def add_child(self, child):
        self.children.append(child)

    def is_leaf(self):
        return not self.children


def _quote(label):
    if label is None:
        return ""
    label = str(label)
    if any(c in label for c in " ,():;'"):
        return "'" + label.replace("'", "_") + "'"
    return label


def to_newick(root):
    """Newick string (with branch lengths) for a Node tree."""
    parts = []

    def emit(node):
        if node.is_leaf():
            s = _quote(node.label)
        else:
            s = "(" + ",".join(emit(c) for c in node.children) + ")"
            if node.label is not None:
                s += _quote(node.label)
        if node.edge_length is not None:
            s += ":" + f"{node.edge_length:.6f}"
        return s

    return emit(root) + ";"


def parse_newick(s):
    """Minimal newick parser returning a Node tree."""
    s = s.strip().rstrip(";")
    pos = 0

    def parse_clade():
        nonlocal pos
        node = Node()
        if s[pos] == "(":
            pos += 1
            while True:
                node.add_child(parse_clade())
                if s[pos] == ",":
                    pos += 1
                else:
                    break
            assert s[pos] == ")", f"newick parse error at {pos}"
            pos += 1
        # label
        start = pos
        if pos < len(s) and s[pos] == "'":
            pos += 1
            while s[pos] != "'":
                pos += 1
            node.label = s[start + 1 : pos]
            pos += 1
        else:
            while pos < len(s) and s[pos] not in ",():;":
                pos += 1
            if pos > start:
                node.label = s[start:pos]
        if pos < len(s) and s[pos] == ":":
            pos += 1
            start = pos
            while pos < len(s) and s[pos] not in ",()":
                pos += 1
            node.edge_length = float(s[start:pos])
        return node

    return parse_clade()


def neighbor_joining(D, labels):
    """Classic NJ over a square distance matrix, Q-matrix vectorised.

    Returns the unrooted tree as a Node (final join as root with children).
    """
    n = D.shape[0]
    if n == 1:
        return Node(labels[0])
    if n == 2:
        root = Node()
        a, b = Node(labels[0], D[0, 1] / 2), Node(labels[1], D[0, 1] / 2)
        root.add_child(a)
        root.add_child(b)
        return root

    # slot-compacted: active nodes always occupy slots 0..m-1 of D, the
    # freed slot is backfilled with the last active row/column — no
    # per-iteration fancy-index gather of the submatrix
    D = np.array(D, dtype=np.float64)
    nodes = [Node(lab) for lab in labels]
    m = n

    while m > 2:
        sub = D[:m, :m]
        r = sub.sum(axis=1)
        Q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(Q, np.inf)
        i_, j_ = np.unravel_index(np.argmin(Q), Q.shape)
        if i_ > j_:
            i_, j_ = j_, i_
        dij = sub[i_, j_]
        li = 0.5 * dij + (r[i_] - r[j_]) / (2 * (m - 2))
        lj = dij - li
        # clamp negative branch lengths to zero (standard practice)
        li = max(li, 0.0)
        lj = max(lj, 0.0)

        parent = Node()
        nodes[i_].edge_length = li
        nodes[j_].edge_length = lj
        parent.add_child(nodes[i_])
        parent.add_child(nodes[j_])

        # new node into slot i: d(u,k) = (d(i,k) + d(j,k) - d(i,j)) / 2
        new_d = 0.5 * (D[i_, :m] + D[j_, :m] - dij)
        D[i_, :m] = new_d
        D[:m, i_] = new_d
        D[i_, i_] = 0.0
        nodes[i_] = parent
        # backfill slot j with the last active slot
        last = m - 1
        if j_ != last:
            D[j_, :m] = D[last, :m]
            D[:m, j_] = D[:m, last]
            D[j_, j_] = 0.0
            nodes[j_] = nodes[last]
        m -= 1

    # join last two, splitting the remaining distance evenly (the tree is
    # midpoint-rooted afterwards, so the split position is immaterial)
    root = Node()
    nodes[0].edge_length = D[0, 1] / 2
    nodes[1].edge_length = D[0, 1] / 2
    root.add_child(nodes[0])
    root.add_child(nodes[1])
    return root


def _adjacency(root):
    """Undirected weighted adjacency {id(node): [(neighbor, weight)]} plus
    the node registry."""
    adj = {}
    registry = {}

    def walk(node, parent):
        registry[id(node)] = node
        adj.setdefault(id(node), [])
        if parent is not None:
            w = node.edge_length or 0.0
            adj[id(node)].append((id(parent), w))
            adj[id(parent)].append((id(node), w))
        for c in node.children:
            walk(c, node)

    walk(root, None)
    return adj, registry


def _farthest(adj, start):
    """Weighted farthest node from start by BFS/DFS over the tree; returns
    (node_id, dist, parent_map)."""
    dist = {start: 0.0}
    parent = {start: None}
    stack = [start]
    far, far_d = start, 0.0
    while stack:
        u = stack.pop()
        for v, w in adj[u]:
            if v not in dist:
                dist[v] = dist[u] + w
                parent[v] = u
                stack.append(v)
                if dist[v] > far_d:
                    far, far_d = v, dist[v]
    return far, far_d, parent


def midpoint_root(root):
    """Re-root the tree at the midpoint of its longest leaf-leaf path."""
    adj, registry = _adjacency(root)
    leaves = [nid for nid, node in registry.items() if node.is_leaf()]
    if len(leaves) < 2:
        return root
    a, _, _ = _farthest(adj, leaves[0])
    b, diam, parent = _farthest(adj, a)
    if diam <= 0:
        return root
    # path from b back to a
    path = [b]
    while parent[path[-1]] is not None:
        path.append(parent[path[-1]])
    # walk along path until cumulative length >= diam/2
    half = diam / 2.0
    acc = 0.0
    for idx in range(len(path) - 1):
        u, v = path[idx], path[idx + 1]
        w = next(wt for (nb, wt) in adj[u] if nb == v)
        if acc + w >= half:
            # root on edge (u, v), at distance (half - acc) from u
            return _reroot_on_edge(adj, registry, u, v, half - acc, w)
        acc += w
    return root


def _reroot_on_edge(adj, registry, u, v, dist_from_u, edge_w):
    """Build a new rooted Node tree with the root placed on edge (u, v)."""
    new_nodes = {}

    def build(nid, banned, length):
        node = registry[nid]
        fresh = Node(node.label if node.is_leaf() else None, length)
        for nb, w in adj[nid]:
            if nb != banned:
                fresh.add_child(build(nb, nid, w))
        # collapse pass-through internal nodes of degree 2 (old root)
        if len(fresh.children) == 1 and not node.is_leaf():
            child = fresh.children[0]
            child.edge_length = (child.edge_length or 0.0) + (length or 0.0)
            return child
        return fresh

    root = Node()
    left = build(u, v, dist_from_u)
    right = build(v, u, edge_w - dist_from_u)
    root.add_child(left)
    root.add_child(right)
    return root


def build_rapidnj(rapidnj, ref_list, core_mat, out_prefix, tmp=None, threads=1):
    """External rapidnj path (buildRapidNJ, trees.py:31-93)."""
    base = os.path.basename(out_prefix)
    phylip_dir = tmp if tmp is not None else out_prefix
    phylip_name = os.path.join(phylip_dir, base + "_core_distances.phylip")
    with open(phylip_name, "w") as p_file:
        p_file.write(str(len(ref_list)) + "\n")
        for core_dist, ref in zip(core_mat, ref_list):
            p_file.write(ref + " " + " ".join(map("{:.4f}".format, core_dist))
                         + "\n")
    tree_filename = os.path.join(out_prefix, base + "_core_NJ.nwk")
    cmd = (rapidnj + " " + phylip_name + " -n -i pd -o t -x "
           + tree_filename + ".raw -c " + str(threads))
    try:
        subprocess.run(cmd, shell=True, check=True)
        with open(tree_filename + ".raw") as f, open(tree_filename, "w") as fo:
            for line in f:
                fo.write(line.replace("'", ""))
        os.remove(tree_filename + ".raw")
    except subprocess.CalledProcessError as e:
        sys.stderr.write("Could not run command " + cmd + "; returned code: "
                         + str(e.returncode) + "\n")
        raise
    finally:
        if os.path.isfile(phylip_name):
            os.remove(phylip_name)
    with open(tree_filename) as f:
        tree = parse_newick(f.read())
    os.remove(tree_filename)
    return tree


def generate_nj_tree(core_mat, seq_labels, out_prefix, tmp=None, rapidnj=None,
                     threads=1, device=None):
    """NJ tree (newick string) from a square core-distance matrix
    (trees.py:160-196); the NJ runs on ``device`` where ``use_device_nj``
    says so (None: ``_device.resolve``'s choice)."""
    sys.stderr.write("Building phylogeny\n")
    if rapidnj is not None:
        tree = build_rapidnj(rapidnj, seq_labels, core_mat, out_prefix,
                             tmp=tmp, threads=threads)
    else:
        from .ops.nj_device import neighbor_joining_device, use_device_nj

        if use_device_nj(len(seq_labels), device):
            sys.stderr.write("Running NJ on device\n")
            tree = neighbor_joining_device(np.asarray(core_mat), seq_labels,
                                           device)
        else:
            tree = neighbor_joining(np.asarray(core_mat, dtype=np.float64),
                                    seq_labels)
    tree = midpoint_root(tree)
    return to_newick(tree).replace("'", "")


def write_tree(tree, prefix, suffix, overwrite):
    """(trees.py:95-112)."""
    tree_filename = os.path.join(prefix, os.path.basename(prefix) + suffix)
    if overwrite or not os.path.isfile(tree_filename):
        with open(tree_filename, "w") as tree_file:
            tree_file.write(tree)
    else:
        sys.stderr.write("Unable to write phylogeny to " + tree_filename + "\n")


def load_tree(prefix, type, distances="core"):
    """Reuse an existing tree from a previous run (trees.py:131-158)."""
    tree_prefix = os.path.join(prefix, os.path.basename(prefix))
    for suffix in ("_" + distances + "_" + type + ".tree",
                   "_" + distances + "_" + type + ".nwk"):
        tree_fn = tree_prefix + suffix
        if os.path.isfile(tree_fn):
            sys.stderr.write("Reading existing tree from " + tree_fn + "\n")
            with open(tree_fn) as f:
                return to_newick(parse_newick(f.read())).replace("'", "")
    return None


def mst_to_phylogeny(mst_network, names):
    """MST graph -> phylogeny newick (trees.py:199-264).

    BFS from the most-connected seed; internal nodes are duplicated as
    zero-length leaves so all samples appear as tips.
    """
    edges = mst_network.edges
    weights = (mst_network.weights if mst_network.weights is not None
               else np.zeros(edges.shape[0]))
    n = mst_network.n_vertices
    tree_nodes = [Node(names[v]) for v in range(n)]

    # seed = vertex appearing most often in the edge list
    counts = np.bincount(edges.ravel(), minlength=n)
    seed = int(np.argmax(counts))

    adj = [[] for _ in range(n)]
    for (u, v), w in zip(edges, weights):
        adj[int(u)].append((int(v), float(w)))
        adj[int(v)].append((int(u), float(w)))

    added = {seed}
    order = [seed]
    i = 0
    while i < len(order):
        u = order[i]
        for v, w in adj[u]:
            if v not in added:
                tree_nodes[u].add_child(tree_nodes[v])
                tree_nodes[v].edge_length = w
                added.add(v)
                order.append(v)
        i += 1

    # zero-length leaf duplicates for internal nodes
    def fix_internal(node):
        for c in list(node.children):
            fix_internal(c)
        if node.children and node.label is not None:
            dup = Node(node.label, 0.0)
            node.label = None
            node.add_child(dup)

    root = tree_nodes[seed]
    fix_internal(root)
    return to_newick(root).replace("'", "")
