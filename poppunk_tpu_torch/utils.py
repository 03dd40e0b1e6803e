"""General I/O and small helpers (counterpart of PopPUNK/utils.py).

Copied from ``poppunk_tpu/utils.py``, whose counterpart it is: this package
imports nothing of the JAX package.
"""

import os
import pickle
from collections import defaultdict

import numpy as np


def db_h5_path(prefix: str) -> str:
    """``<prefix>/<basename(prefix)>.h5`` naming convention used everywhere
    in the reference (e.g. PopPUNK/sketchlib.py:124)."""
    return os.path.join(prefix, os.path.basename(prefix) + ".h5")


def out_prefix_path(prefix: str, suffix: str = "") -> str:
    return os.path.join(prefix, os.path.basename(prefix) + suffix)


def store_pickle(rlist, qlist, self, X, pkl_name):
    """Save distances: names to ``.pkl``, matrix to ``.npy``
    (PopPUNK/utils.py:135-157)."""
    with open(pkl_name + ".pkl", "wb") as f:
        pickle.dump([list(rlist), list(qlist), bool(self)], f)
    if isinstance(X, np.ndarray):
        np.save(pkl_name + ".npy", X)


def read_pickle(pkl_name, enforce_self=False, distances=True):
    """Load distances saved by :func:`store_pickle`
    (PopPUNK/utils.py:160-196)."""
    with open(pkl_name + ".pkl", "rb") as f:
        rlist, qlist, self = pickle.load(f)
    if enforce_self and (not self or rlist != qlist):
        raise RuntimeError(f"Distances {pkl_name} are not an all-vs-all self dataset")
    X = np.load(pkl_name + ".npy") if distances else None
    return rlist, qlist, self, X


def isolate_name_to_label(names):
    """Sanitise isolate names for downstream tools
    (PopPUNK/utils.py:473-488)."""
    return [
        name.split("/")[-1].replace(".", "_").replace(":", "").replace("(", "_").replace(")", "_")
        for name in names
    ]


def read_rfile(rfile, one_seq=False):
    """Read tab-separated ``name<TAB>file...`` lists; names sanitised and the
    (name, files) pairs returned sorted by name (PopPUNK/utils.py:410-471)."""
    names = []
    sequences = []
    with open(rfile) as f:
        for line in f:
            fields = line.rstrip().split("\t")
            if len(fields) < 2:
                raise RuntimeError(
                    "Input reference list is misformatted\n"
                    "Must contain sample name and file, tab separated"
                )
            if "/" in fields[0]:
                raise RuntimeError("Sample names may not contain slashes")
            names.append(fields[0])
            sequences.append(fields[1] if one_seq else fields[1:])

    names = isolate_name_to_label(names)
    if len(set(names)) != len(names):
        seen = set()
        dupes = set(x for x in names if x in seen or seen.add(x))
        raise RuntimeError("Input contains duplicate names: " + ",".join(sorted(dupes)))

    order = sorted(range(len(names)), key=lambda i: names[i])
    return [names[i] for i in order], [sequences[i] for i in order]


def read_isolate_type_from_csv(clust_csv, mode="clusters", return_dict=False):
    """Read cluster definitions from CSV (PopPUNK/utils.py:264-319).

    Returns {column: {cluster: set(samples)}} or, with return_dict,
    {column: {sample: cluster}}.
    """
    import pandas as pd

    clusters = defaultdict(dict) if return_dict else {}
    df = pd.read_csv(clust_csv, index_col=0, quotechar='"')

    if mode == "clusters":
        type_columns = [n for n, col in enumerate(df.columns) if "Cluster" in col]
    elif mode == "lineages":
        type_columns = [n for n, col in enumerate(df.columns) if ("Rank_" in col or "overall" in col)]
    elif mode == "external":
        if len(df.columns) == 1:
            type_columns = [0]
        else:
            type_columns = range(len(df.columns) - 1)
    else:
        raise ValueError("Unknown CSV reading mode: " + mode)

    for row in df.itertuples():
        for cls_idx in type_columns:
            cluster_name = df.columns[cls_idx].replace("__autocolour", "")
            if return_dict:
                clusters[cluster_name][str(row.Index)] = str(row[cls_idx + 1])
            else:
                if cluster_name not in clusters:
                    clusters[cluster_name] = defaultdict(set)
                clusters[cluster_name][str(row[cls_idx + 1])].add(row.Index)
    return clusters


def join_cluster_dicts(d1, d2):
    """Concatenate two return_dict-style cluster dicts
    (PopPUNK/utils.py:322-354)."""
    matching = set(d1.keys()).intersection(d2.keys())
    if not matching:
        raise RuntimeError("Cluster columns do not match between sets being combined")
    for column in list(d1.keys()):
        if column in matching:
            d1[column] = {**d1[column], **d2[column]}
        else:
            del d1[column]
    return d1


def create_overall_lineage(rank_list, lineage_clusters):
    """Combine per-rank lineage assignments into an overall string
    (PopPUNK/utils.py:491-506)."""
    overall = {"Rank_" + str(r): {} for r in rank_list}
    overall["overall"] = {}
    for isolate in lineage_clusters[rank_list[0]]:
        parts = []
        for rank in rank_list:
            overall["Rank_" + str(rank)][isolate] = lineage_clusters[rank][isolate]
            parts.append(str(lineage_clusters[rank][isolate]))
        overall["overall"][isolate] = "-".join(parts)
    return overall


def transform_line(s, mean0, mean1):
    """Point a distance ``s`` along the line mean0 -> mean1
    (PopPUNK/utils.py:509-532)."""
    dx = mean1[0] - mean0[0]
    dy = mean1[1] - mean0[1]
    ds = np.sqrt(dx * dx + dy * dy)
    return np.array([mean0[0] + s * (dx / ds), mean0[1] + s * (dy / ds)])


def decision_boundary(intercept, gradient, adj=0.0):
    """Axis intercepts of the boundary normal through ``intercept``
    (PopPUNK/utils.py:535-560)."""
    intercept = np.array(intercept, dtype=float)
    if adj != 0.0:
        hyp = (intercept[0] ** 2 + intercept[1] ** 2) ** 0.5
        ratio = (hyp + adj) / hyp
        intercept = intercept * ratio
    x = intercept[0] + intercept[1] * gradient
    y = intercept[1] + intercept[0] / gradient
    return (x, y)


def read_rlist_from_distance_pickle(fn, allow_non_self=True, include_queries=False,
                                    only_queries=False):
    """Names from a distance pickle (PopPUNK/utils.py:596-622)."""
    with open(fn, "rb") as f:
        rlist, qlist, self = pickle.load(f)
    if not allow_non_self and not self:
        raise RuntimeError("This analysis requires an all-v-all distance dataset")
    if only_queries:
        return qlist
    if include_queries:
        return rlist + qlist
    return rlist
