"""Quality control of sketches, distances and assignments.

Re-implements the reference's PopPUNK/qc.py with vectorised numpy in place
of its per-row Python loops:

- ``prune_distance_matrix`` (qc.py:17): drop samples from a condensed
  distance matrix — here a single boolean gather over condensed rows
  instead of the reference's row-by-row copy loop.
- ``sketch_qc`` (sketchlibAssemblyQC, qc.py:137): genome length ±sigma (or
  explicit range) and ambiguous-base thresholds from the sketch DB attrs.
- ``qc_dist_mat`` (qcDistMat, qc.py:295): max core/accessory cutoffs and
  zero-proportion check, bad edges greedily pruned per ``prune_edges``
  (qc.py:419), preferring queries.
- ``auto_dist_find`` (autoDistFind, qc.py:238): percentile jump detection.
- ``qc_query_assignments`` (qcQueryAssignments, qc.py:372): per-query
  cluster-link count limit.
- ``remove_qc_fail`` (qc.py:468): prune DB + distances + graph, recompute
  random-match chances, write the ``_qcreport.txt``.

Copied from ``poppunk_tpu/qc.py``, whose counterpart it is: this package
imports nothing of the JAX package.
"""

import os
import sys
from collections import Counter

import numpy as np

from .utils import read_isolate_type_from_csv, store_pickle

DEFAULT_QC = {
    "run_qc": False,
    "retain_failures": False,
    "no_remove": False,
    "length_sigma": 5,
    "length_range": [None, None],
    "prop_n": 0.1,
    "upper_n": None,
    "max_pi_dist": 0.1,
    "max_a_dist": 0.5,
    "prop_zero": 0.05,
    "max_merge": -1,
    "betweenness": False,
    "type_isolate": None,
    "x": 0.2,
    "r": 50,
}


def _condensed_keep_mask(n, removal_indices):
    """Boolean mask over the n*(n-1)/2 condensed rows keeping pairs whose
    endpoints both survive."""
    keep = np.ones(n, dtype=bool)
    keep[list(removal_indices)] = False
    i, j = np.triu_indices(n, k=1)
    return keep[i] & keep[j]


def prune_distance_matrix(ref_list, remove_seqs_in, dist_mat, output):
    """Drop sequences from a condensed distance matrix (qc.py:17-93).

    Returns (new_ref_list, new_dist_mat); also stores the pickle/npy pair.
    """
    index_of = {name: idx for idx, name in enumerate(ref_list)}
    removal_indices = []
    for to_remove in remove_seqs_in:
        if to_remove in index_of:
            removal_indices.append(index_of[to_remove])
        else:
            sys.stderr.write("Couldn't find " + to_remove + " in database\n")

    if removal_indices:
        sys.stderr.write(
            "Removing " + str(len(set(removal_indices))) + " sequences\n"
        )
        mask = _condensed_keep_mask(len(ref_list), removal_indices)
        new_dist_mat = dist_mat[mask]
        removed = set(removal_indices)
        new_ref_list = [s for i, s in enumerate(ref_list) if i not in removed]
    else:
        new_ref_list = ref_list
        new_dist_mat = dist_mat

    store_pickle(new_ref_list, new_ref_list, True, new_dist_mat, output)
    return new_ref_list, new_dist_mat


def prune_query_distance_matrix(ref_list, query_list, remove_seqs, qr_dist_mat,
                                query_assign=None):
    """Remove per-query row blocks from a query-vs-ref matrix
    (qc.py:94-135)."""
    if set(remove_seqs).intersection(ref_list):
        raise RuntimeError("Trying to remove references")
    keep_q = np.array([name not in remove_seqs for name in query_list])
    passing_queries = [n for n, k in zip(query_list, keep_q) if k]
    pass_rows = np.repeat(keep_q, len(ref_list))
    qr_dist_mat = qr_dist_mat[pass_rows, :]
    if query_assign is not None:
        query_assign = np.asarray(query_assign)[pass_rows]
    return passing_queries, qr_dist_mat, query_assign


def sketch_qc(prefix, names, qc_dict):
    """Length/ambiguous-base QC from sketch DB attributes
    (sketchlibAssemblyQC, qc.py:137-236)."""
    import h5py

    from .utils import db_h5_path

    sys.stderr.write("Running QC on sketches\n")
    if qc_dict["upper_n"] is not None:
        sys.stderr.write(
            "Using count cutoff for ambiguous bases: "
            + str(qc_dict["upper_n"]) + "\n"
        )
    else:
        sys.stderr.write(
            "Using proportion cutoff for ambiguous bases: "
            + str(qc_dict["prop_n"]) + "\n"
        )
    if qc_dict["length_range"][0] is None:
        sys.stderr.write(
            "Using standard deviation for length cutoff: "
            + str(qc_dict["length_sigma"]) + "\n"
        )
    else:
        sys.stderr.write(
            "Using range for length cutoffs: "
            + str(qc_dict["length_range"][0]) + " - "
            + str(qc_dict["length_range"][1]) + "\n"
        )

    failed_samples = {}
    name_set = frozenset(names)
    seq_length = {}
    seq_ambiguous = {}
    with h5py.File(db_h5_path(prefix), "r") as hdf_in:
        read_grp = hdf_in["sketches"]
        for dataset in read_grp:
            if dataset in name_set:
                attrs = read_grp[dataset].attrs
                seq_length[dataset] = attrs["length"]
                if attrs.get("reads", False):
                    seq_ambiguous[dataset] = 0
                else:
                    seq_ambiguous[dataset] = attrs["missing_bases"]

    genome_lengths = np.fromiter(seq_length.values(), dtype=int)
    mean_len = np.mean(genome_lengths)
    if qc_dict["length_range"][0] is None:
        lower_length = mean_len - qc_dict["length_sigma"] * np.std(genome_lengths)
        upper_length = mean_len + qc_dict["length_sigma"] * np.std(genome_lengths)
    else:
        lower_length, upper_length = qc_dict["length_range"]

    for dataset, length in seq_length.items():
        if length < lower_length:
            failed_samples[dataset] = ["Below lower length threshold"]
        elif length > upper_length:
            failed_samples[dataset] = ["Above upper length threshold"]
        n_count = seq_ambiguous[dataset]
        if (qc_dict["upper_n"] is not None and n_count > qc_dict["upper_n"]) or (
            n_count > qc_dict["prop_n"] * length
        ):
            failed_samples.setdefault(dataset, []).append(
                "Ambiguous sequence too high"
            )

    retained = [x for x in names if x not in failed_samples]
    return retained, failed_samples


def auto_dist_find(dist_mat, qc_dict):
    """Percentile jump detection for max-distance cutoffs
    (autoDistFind, qc.py:238-292)."""
    L = len(dist_mat)
    n = int(L / qc_dict["r"])
    step = int(n // 100)
    s = step - 1
    y = 100 * step * qc_dict["x"] / n + 1
    percentiles = np.linspace(100 / n, 100, n)
    sys.stderr.write(
        f"Detecting maximum distance cutoffs using x = {qc_dict['x']}, "
        f"r = {qc_dict['r']}\n"
    )

    cutoffs = []
    for col in (0, 1):
        pcs = np.percentile(dist_mat[:, col], percentiles)
        start = int(len(pcs) * 0.75)
        idx = np.arange(start, len(pcs) - 1)
        jump = pcs[idx - s] * y < pcs[idx + 1]
        if jump.any():
            cutoffs.append(pcs[idx[jump]].min())
        else:
            cutoffs.append(dist_mat[:, col].max())
            which = "core" if col == 0 else "accessory"
            sys.stderr.write(f"No outlier detected in {which} distance")
    return cutoffs[0], cutoffs[1]


def _bad_rows_to_edges(bad_rows, n_ref, self):
    """Edge (i, j) per failing condensed/rect row (generateTuples twin)."""
    bad_rows = np.asarray(bad_rows)
    if self:
        i, j = np.triu_indices(n_ref, k=1)
        return list(zip(i[bad_rows].tolist(), j[bad_rows].tolist()))
    # query mode: row = q * n_ref + r; edge = (r, n_ref + q)
    q = bad_rows // n_ref
    r = bad_rows % n_ref
    return list(zip(r.tolist(), (n_ref + q).tolist()))


def prune_edges(long_edges, query_start, failed=None, min_count=1,
                allow_ref_ref=True):
    """Greedy bad-node pruning preferring queries (qc.py:419-466)."""
    if failed is None:
        failed = set()
    if long_edges:
        counts = Counter()
        for (r, q) in long_edges:
            counts.update([r, q])
        long_edges.sort(key=lambda x: max(counts[x[0]], counts[x[1]]),
                        reverse=True)
        for (r, q) in long_edges:
            if q not in failed and r not in failed and (
                counts[r] >= min_count or counts[q] >= min_count
            ):
                if r < query_start and q < query_start:
                    if allow_ref_ref:
                        if counts[r] > counts[q] and counts[r] >= min_count:
                            failed.add(r)
                        elif counts[q] >= min_count:
                            failed.add(q)
                elif r < query_start and q >= query_start:
                    failed.add(q)
                else:
                    if counts[r] > counts[q] and counts[r] >= min_count:
                        failed.add(r)
                    elif counts[q] >= min_count:
                        failed.add(q)
    return failed


def qc_dist_mat(dist_mat, ref_list, query_list, ref_db, qc_dict):
    """Distance-matrix outlier QC (qcDistMat, qc.py:295-369)."""
    sys.stderr.write("Running QC on distances\n")
    sys.stderr.write(
        "Using cutoff for core distances: " + str(qc_dict["max_pi_dist"]) + "\n"
    )
    sys.stderr.write(
        "Using cutoff for accessory distances: " + str(qc_dict["max_a_dist"]) + "\n"
    )
    sys.stderr.write(
        "Using cutoff for proportion of zero distances: "
        + str(qc_dict["prop_zero"]) + "\n"
    )

    if ref_list == query_list:
        names = ref_list
        self = True
    else:
        names = ref_list + query_list
        self = False

    long_rows = np.where(
        (dist_mat[:, 0] > qc_dict["max_pi_dist"])
        | (dist_mat[:, 1] > qc_dict["max_a_dist"])
    )[0]
    long_edges = _bad_rows_to_edges(long_rows, len(ref_list), self)
    failed = prune_edges(long_edges, query_start=len(ref_list),
                         allow_ref_ref=self)
    failed_samples = {
        names[x]: ["Failed distance QC (too high)"] for x in failed
    }

    if qc_dict["prop_zero"] < 1:
        zero_count = round(qc_dict["prop_zero"] * len(names))
        zero_rows = np.where((dist_mat[:, 0] == 0) | (dist_mat[:, 1] == 0))[0]
        zero_edges = _bad_rows_to_edges(zero_rows, len(ref_list), self)
        failed = prune_edges(zero_edges, query_start=len(ref_list),
                             failed=failed, min_count=zero_count,
                             allow_ref_ref=self)
        message = ["Failed distance QC (too many zeros)"]
        for sample in failed:
            name = names[sample]
            if name in failed_samples:
                failed_samples[name] += message
            else:
                failed_samples[name] = message

    retained = [x for x in names if x not in failed_samples]
    return retained, failed_samples


def qc_query_assignments(r_list, q_list, query_assignments, max_clusters,
                         original_cluster_file):
    """Limit the number of clusters a query may link
    (qcQueryAssignments, qc.py:372-417)."""
    message = ["Failed graph QC (too many links)"]
    retained, failed_samples = [], {}
    clusters = read_isolate_type_from_csv(original_cluster_file,
                                          return_dict=True)
    clusters_idx = {
        idx: clusters["Cluster"][name] for idx, name in enumerate(r_list)
    }
    assignments = np.asarray(query_assignments)
    for idx, query in enumerate(q_list):
        block = assignments[idx * len(r_list) : (idx + 1) * len(r_list)]
        edges = np.argwhere(block == -1).reshape(-1)
        cluster_links = {clusters_idx[int(e)] for e in edges}
        if len(cluster_links) > max_clusters:
            failed_samples[query] = message
        else:
            retained.append(query)
    return retained, failed_samples


def remove_qc_fail(qc_dict, names, passed, fail_dicts, ref_db, dist_mat,
                   prefix, strand_preserved=False, threads=1):
    """Prune DB, distances and graph; recompute random matches; write the
    QC report (qc.py:468-552)."""
    from .io.hdf5db import add_random, get_db_kmers, remove_from_db
    from .network.graph import prune_graph
    from .utils import db_h5_path

    os.makedirs(prefix, exist_ok=True)
    failed = set(names) - set(passed)
    if qc_dict["retain_failures"]:
        remove_from_db(
            db_h5_path(ref_db),
            f"{prefix}/failed.{os.path.basename(prefix)}.h5",
            passed,
            full_names=True,
        )
    new_dist_mat = dist_mat
    if not qc_dict["no_remove"]:
        tmp_name = f"{prefix}/filtered.{os.path.basename(prefix)}.h5"
        remove_from_db(db_h5_path(ref_db), tmp_name, failed, full_names=True)
        os.rename(tmp_name, db_h5_path(prefix))
        _, new_dist_mat = prune_distance_matrix(
            names, failed, dist_mat,
            f"{prefix}/{os.path.basename(prefix)}.dists",
        )
        prune_graph(ref_db, names, passed, prefix)
        sys.stderr.write(
            "Recalculating random matches with strand_preserved = "
            + str(strand_preserved) + "\n"
        )
        add_random(prefix, passed, get_db_kmers(ref_db),
                   strand_preserved=strand_preserved, overwrite=True)

    write_qc_failure_report(failed, fail_dicts, prefix)
    return new_dist_mat


def write_qc_failure_report(failed_samples, fail_dicts, output_prefix):
    """(qc.py:554-571)."""
    lines = [
        f"{sample}\t{','.join(get_failure_reasons(sample, fail_dicts))}\n"
        for sample in failed_samples
    ]
    report = f"{output_prefix}/{os.path.basename(output_prefix)}_qcreport.txt"
    with open(report, "w") as qc_file:
        qc_file.writelines(lines)


def get_failure_reasons(sample, fail_dicts):
    """(qc.py:573-585)."""
    return [
        reason
        for fail_dict in fail_dicts
        if sample in fail_dict
        for reason in fail_dict[sample]
    ]
