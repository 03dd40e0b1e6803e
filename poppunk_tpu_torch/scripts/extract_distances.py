"""Extract a TSV of distances from pkl/npy (or sparse) distance files
(scripts/poppunk_extract_distances.py)."""

import argparse

import numpy as np


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_extract_distances",
        description="Extract tab-separated distances from pkl/npy files")
    parser.add_argument("--distances", required=True,
                        help="Prefix of distance pickle (and npy)")
    parser.add_argument("--sparse", help="Sparse distance matrix file name")
    parser.add_argument("--tree", help="Newick phylogeny to add patristic "
                                       "distances from")
    parser.add_argument("--output", required=True)
    return parser.parse_args(arg_list)


def iter_pair_names(rlist, qlist, self_mode):
    from ..pairs import iter_dist_rows

    return iter_dist_rows(rlist, qlist, self=self_mode)


def _tree_distances(tree_file, pairs):
    """Patristic distances for the named pairs from a newick tree."""
    from ..trees import parse_newick, _adjacency

    root = parse_newick(open(tree_file).read())
    adj, registry = _adjacency(root)
    name_to_id = {node.label: nid for nid, node in registry.items()
                  if node.label}
    import heapq

    cache = {}

    def dist_from(src):
        if src in cache:
            return cache[src]
        dist = {src: 0.0}
        heap = [(0.0, src)]
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist.get(u, np.inf):
                continue
            for v, w in adj[u]:
                nd = d + w
                if nd < dist.get(v, np.inf):
                    dist[v] = nd
                    heapq.heappush(heap, (nd, v))
        cache[src] = dist
        return dist

    out = []
    for a, b in pairs:
        if a in name_to_id and b in name_to_id:
            out.append(dist_from(name_to_id[a])[name_to_id[b]])
        else:
            out.append(float("nan"))
    return out


def main(arg_list=None):
    args = get_options(arg_list)
    from ..utils import read_pickle

    rlist, qlist, self_mode, X = read_pickle(args.distances)
    pairs = list(iter_pair_names(rlist, qlist, self_mode))

    sparse_lookup = None
    if args.sparse:
        import scipy.sparse

        mat = scipy.sparse.load_npz(args.sparse).tocoo()
        sparse_lookup = {(rlist[i], rlist[j]): v
                         for i, j, v in zip(mat.row, mat.col, mat.data)}

    tree_dists = None
    if args.tree:
        tree_dists = _tree_distances(args.tree, pairs)

    with open(args.output, "w") as out:
        header = ["Query", "Subject", "Core", "Accessory"]
        if sparse_lookup is not None:
            header.append("Sparse")
        if tree_dists is not None:
            header.append("Patristic")
        out.write("\t".join(header) + "\n")
        for idx, (a, b) in enumerate(pairs):
            row = [a, b, str(X[idx, 0]), str(X[idx, 1])]
            if sparse_lookup is not None:
                v = sparse_lookup.get((a, b), sparse_lookup.get((b, a)))
                row.append("NA" if v is None else str(v))
            if tree_dists is not None:
                row.append(str(tree_dists[idx]))
            out.write("\t".join(row) + "\n")


if __name__ == "__main__":
    main()
