"""Silhouette score of a clustering over PopPUNK distances
(scripts/poppunk_calculate_silhouette.py)."""

import argparse

import numpy as np


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_silhouette",
        description="Calculate silhouette coefficient of a clustering")
    parser.add_argument("--distances", required=True,
                        help="Prefix of distance pickle/npy pair")
    parser.add_argument("--cluster-csv", required=True,
                        help="Cluster CSV (Taxon,Cluster)")
    parser.add_argument("--cluster-col", type=int, default=1)
    return parser.parse_args(arg_list)


def main(arg_list=None):
    import pandas as pd
    from sklearn.metrics import silhouette_score

    from ..pairs import condensed_to_square
    from ..utils import read_pickle

    args = get_options(arg_list)
    rlist, qlist, self_mode, X = read_pickle(args.distances,
                                             enforce_self=True)
    df = pd.read_csv(args.cluster_csv, dtype=str)
    mapping = dict(zip(df[df.columns[0]], df[df.columns[args.cluster_col]]))
    labels = np.array([mapping[name] for name in rlist])

    # Euclidean (core, accessory) distance matrix
    sq = np.sqrt(condensed_to_square(X[:, 0], len(rlist)) ** 2
                 + condensed_to_square(X[:, 1], len(rlist)) ** 2)
    score = silhouette_score(sq, labels, metric="precomputed")
    print(f"Silhouette coefficient: {score:.6f}")
    return score


if __name__ == "__main__":
    main()
