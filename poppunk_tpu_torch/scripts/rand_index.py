"""Rand index between clusterings
(scripts/poppunk_calculate_rand_indices.py)."""

import argparse
import sys
from itertools import combinations

import numpy as np
import pandas as pd
from scipy.special import comb


def rand_index_score(labels_true, labels_pred):
    """Plain (unadjusted) Rand index."""
    labels_true = np.asarray(labels_true)
    labels_pred = np.asarray(labels_pred)
    n = labels_true.shape[0]
    if n < 2:
        return 1.0
    # contingency counts
    true_ids = {v: i for i, v in enumerate(np.unique(labels_true))}
    pred_ids = {v: i for i, v in enumerate(np.unique(labels_pred))}
    cont = np.zeros((len(true_ids), len(pred_ids)), dtype=np.int64)
    for t, p in zip(labels_true, labels_pred):
        cont[true_ids[t], pred_ids[p]] += 1
    sum_comb = comb(cont, 2).sum()
    sum_rows = comb(cont.sum(axis=1), 2).sum()
    sum_cols = comb(cont.sum(axis=0), 2).sum()
    total = comb(n, 2)
    return float((total + 2 * sum_comb - sum_rows - sum_cols) / total)


def adjusted_rand(labels_true, labels_pred):
    from sklearn.metrics import adjusted_rand_score

    return float(adjusted_rand_score(labels_true, labels_pred))


def get_options(arg_list=None):
    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_rand_index",
        description="Calculate Rand indices between clusterings")
    parser.add_argument("--input", required=True,
                        help="Comma separated list of cluster CSV files")
    parser.add_argument("--adjusted", action="store_true",
                        help="Also compute the adjusted Rand index")
    parser.add_argument("--subset", help="File with a subset of names to use")
    parser.add_argument("--output", required=True)
    return parser.parse_args(arg_list)


def main(arg_list=None):
    args = get_options(arg_list)
    files = args.input.split(",")
    if len(files) < 2:
        sys.stderr.write("Need at least two input files\n")
        sys.exit(1)

    subset = None
    if args.subset:
        with open(args.subset) as f:
            subset = set(line.strip() for line in f if line.strip())

    clusterings = {}
    for fn in files:
        df = pd.read_csv(fn, dtype=str)
        name_col, cluster_col = df.columns[0], df.columns[1]
        mapping = dict(zip(df[name_col], df[cluster_col]))
        if subset:
            mapping = {k: v for k, v in mapping.items() if k in subset}
        clusterings[fn] = mapping

    with open(args.output, "w") as out:
        header = "File_1\tFile_2\tn_samples\tRand_index"
        if args.adjusted:
            header += "\tAdjusted_Rand_index"
        out.write(header + "\n")
        for f1, f2 in combinations(files, 2):
            common = sorted(set(clusterings[f1]) & set(clusterings[f2]))
            if not common:
                sys.stderr.write(f"No common samples between {f1} and {f2}\n")
                continue
            l1 = [clusterings[f1][s] for s in common]
            l2 = [clusterings[f2][s] for s in common]
            # map string labels to ints
            m1 = {v: i for i, v in enumerate(dict.fromkeys(l1))}
            m2 = {v: i for i, v in enumerate(dict.fromkeys(l2))}
            i1 = [m1[v] for v in l1]
            i2 = [m2[v] for v in l2]
            row = f"{f1}\t{f2}\t{len(common)}\t{rand_index_score(i1, i2):.6f}"
            if args.adjusted:
                row += f"\t{adjusted_rand(i1, i2):.6f}"
            out.write(row + "\n")


if __name__ == "__main__":
    main()
