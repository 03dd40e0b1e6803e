"""Web/BeeBOP API glue.

Counterpart of PopPUNK/web.py: JSON sketch -> HDF5 query database
(canonical sketch schema, web.py:14-61), GraphML -> Cytoscape-style JSON
subgraph (web.py:63-92), and cluster prevalence summaries for the web
front end (web.py:123-174). No graph-tool/networkx — the array-native
Graph does the component work.

Copied from ``poppunk_tpu/web.py``, whose counterpart it is: this package
imports nothing of the JAX package. The assignment's distances and model
run on ``device`` (None: ``_device.resolve``'s choice, the card unless
the CPU is asked for).
"""

import json
import os
import sys

import h5py
import numpy as np


def sketch_to_hdf5(sketches_dict, output):
    """Convert a dict of JSON sketches to a query hdf5 database
    (sketch_to_hdf5, web.py:14-61)."""
    q_names = []
    path = os.path.join(output, os.path.basename(output) + ".h5")
    os.makedirs(output, exist_ok=True)
    with h5py.File(path, "w") as query_db:
        sketches = query_db.create_group("sketches")
        for name, value in sketches_dict.items():
            q_names.append(name)
            sketch_dict = json.loads(value) if isinstance(value, str) else value
            props = sketches.create_group(name)
            kmers, dists = [], []
            for key, val in sketch_dict.items():
                try:
                    kmers.append(int(key))
                    dists.append(np.array(val, dtype="uint64"))
                except (TypeError, ValueError):
                    if key == "version":
                        sketches.attrs["sketch_version"] = val
                    elif key == "codon_phased":
                        sketches.attrs["codon_phased"] = val
                    elif key == "bases":
                        props.attrs["base_freq"] = val
                    elif key in ("bbits", "length", "missing_bases",
                                 "sketchsize64"):
                        props.attrs[key] = val
                    elif key in ("densified", "species"):
                        pass
                    else:
                        sys.stderr.write(key + " not recognised\n")
            props.attrs["kmers"] = kmers
            for k, dist in zip(kmers, dists):
                k_spec = props.create_dataset(str(k), data=dist,
                                              dtype="uint64")
                k_spec.attrs["kmer-size"] = k
    return q_names


def sketch_to_json(sketch):
    """Inverse: a Sketch object as the canonical JSON dict (so our
    sketches can feed web front ends expecting the reference schema)."""
    from . import SKETCH_VERSION

    doc = {
        "version": SKETCH_VERSION,
        "codon_phased": False,
        "densified": bool(sketch.densified),
        "bases": list(np.asarray(sketch.base_freq, dtype=float)),
        "bbits": int(sketch.bbits),
        "length": int(sketch.length),
        "missing_bases": int(sketch.missing_bases),
        "sketchsize64": int(sketch.sketchsize64),
    }
    for k, usigs in sketch.usigs.items():
        doc[str(int(k))] = [int(x) for x in np.asarray(usigs)]
    return doc


def graphml_to_json(network_dir):
    """GraphML -> JSON subgraph of the last-listed component
    (graphml_to_json, web.py:63-92)."""
    from .network.components import connected_components
    from .network.graph import Graph

    full = Graph.load_graphml(
        os.path.join(network_dir,
                     os.path.basename(network_dir) + "_cytoscape.graphml"))
    labels, _ = connected_components(full)
    target = labels[-1]
    members = np.flatnonzero(labels == target)
    sub, old_ids = full.subgraph(members, relabel=True)
    sub_labels = [full.vertex_labels[i] for i in old_ids]
    sub.vertex_labels = sub_labels
    sub.save_graphml(os.path.join(network_dir, "subgraph.graphml"),
                     vertex_labels=sub_labels)

    nodes_list = [
        {"data": {"id": f"n{v}", "label": sub_labels[v]}}
        for v in range(sub.n_vertices)
    ]
    edges_list = [
        {"data": {"source": f"n{int(s)}", "target": f"n{int(t)}"}}
        for s, t in sub.edges
    ]
    return {"elements": {"nodes": nodes_list, "edges": edges_list}}


def highlight_cluster(query, cluster):
    """(web.py:94-100)."""
    return "red" if str(cluster) == str(query) else "blue"


def api(query, ref_db):
    """Post the reference tree + clusters to microreact, highlighting the
    query's assigned cluster (api, web.py:103-122; legacy microreact
    project API, kept for the web front end)."""
    import pandas as pd
    import requests

    url = "https://microreact.org/api/project/"
    base = os.path.join(ref_db, os.path.basename(ref_db))
    df = pd.read_csv(base + "_microreact_clusters.csv")
    df["Cluster__autocolour"] = df["Cluster_Cluster__autocolour"]
    df["Highlight_Query__colour"] = df.apply(
        lambda row: highlight_cluster(query, row["Cluster__autocolour"]),
        axis=1)
    df = df.drop(columns=["Cluster_Cluster__autocolour"])
    with open(base + ".nwk") as nwk:
        tree = nwk.read()
    description = (
        "A tree representing all samples in the reference database, "
        "excluding the query sequence but highlighting its assigned "
        "cluster. The cluster assigned to the query is coloured red. If no "
        "clusters are highlighted red, query sequence was assigned to a "
        "new cluster.")
    data = {"name": "PopPUNK-web", "description": description,
            "data": df.to_csv(), "tree": tree}
    response = json.loads(requests.post(url, data=data).text)
    return response.get("url", url)


def calc_prevalence(cluster, cluster_list, num_samples):
    """(web.py:123-127)."""
    return round(cluster_list.count(cluster) / num_samples * 100, 2)


def get_aliases(alias_df, cluster_labels, species):
    """(web.py:129-137)."""
    if species == "Streptococcus pneumoniae":
        gps_name = "unrecognised"
        for label in cluster_labels:
            if label in list(alias_df["sample"]):
                index = list(alias_df["sample"]).index(label)
                gps_name = alias_df["GPSC"][index]
        return {"GPSC": str(gps_name)}
    return {"Aliases": "NA"}


def summarise_clusters(output, species, species_db, q_names):
    """Query and overall cluster prevalences + per-cluster include lists
    (summarise_clusters, web.py:139-174)."""
    import pandas as pd

    total_df = pd.read_csv(
        os.path.join(output, os.path.basename(output) + "_clusters.csv"))
    query_df = total_df[total_df["Taxon"].isin(q_names)].reset_index(drop=True)
    queries_names = list(query_df["Taxon"])
    queries_clusters = list(query_df["Cluster"])
    num_samples = len(total_df["Taxon"])
    total_df["Cluster"] = total_df["Cluster"].astype(str)
    cluster_list = list(total_df["Cluster"])

    total_df["Prevalence"] = total_df.apply(
        lambda row: calc_prevalence(row["Cluster"], cluster_list,
                                    num_samples), axis=1)
    total_df = total_df.sort_values(by="Prevalence", ascending=False)
    unique_df = total_df.drop_duplicates(subset=["Cluster"])
    clusters = list(unique_df["Cluster"])
    prevalences = list(unique_df["Prevalence"])

    queries_prevalence = []
    to_include = []
    for query in queries_clusters:
        queries_prevalence.append(prevalences[clusters.index(str(query))])
        cluster_df = total_df.loc[total_df["Cluster"] == str(query)]
        to_include = list(cluster_df["Taxon"])
        with open(os.path.join(output, "include" + str(query) + ".txt"),
                  "w") as f:
            f.write("\n".join(to_include))

    alias_file = os.path.join(species_db, "aliases.csv")
    if os.path.isfile(alias_file):
        import pandas as pd

        alias_df = pd.read_csv(alias_file)
        alias_dict = get_aliases(alias_df, to_include, species)
    else:
        alias_dict = {"Aliases": "NA"}
    return (queries_names, queries_clusters, queries_prevalence, clusters,
            prevalences, alias_dict, to_include)


def assign_sketch_json(sketches, ref_db, output, species="",
                       species_db=None, qc_dict=None, device=None):
    """The PopPUNK-web request flow as one call: JSON sketches in,
    cluster assignments + prevalence summary out.

    This is what the reference's ``poppunk_api-runner.py`` intends to
    expose (it imports a ``main`` that PopPUNK/web.py never defines; the
    working flow lives in the external PopPUNK-web/beebop service).
    Steps: sketch_to_hdf5 -> assign_query_hdf5 (full network) ->
    summarise_clusters -> JSON-serialisable response dict.

    ``sketches``: dict name -> sketch (canonical JSON dict or string).
    """
    from . import _device
    from .assign import assign_query_hdf5
    from .qc import DEFAULT_QC

    device = _device.resolve(device)
    if qc_dict is None:
        qc_dict = dict(DEFAULT_QC)
    output = output.rstrip("/")
    q_names = sketch_to_hdf5(sketches, output)
    assign_query_hdf5(ref_db.rstrip("/"), q_names, output, qc_dict,
                      save_partial_query_graph=True, dist_device=device,
                      model_device=device)
    (names, clusters_q, prevalence_q, clusters, prevalences, aliases,
     to_include) = summarise_clusters(output, species,
                                      species_db or ref_db, q_names)
    return {
        "species": species,
        "queries": [
            {"name": n, "cluster": str(c), "prevalence": p,
             "aliases": aliases}
            for n, c, p in zip(names, clusters_q, prevalence_q)
        ],
        "clusters": [
            {"cluster": str(c), "prevalence": p}
            for c, p in zip(clusters, prevalences)
        ],
    }


def main(arg_list=None):
    """``poppunk_tpu_torch_api`` entry point (counterpart of the reference's
    poppunk_api-runner.py, which wraps PopPUNK/web.py): assign JSON
    sketches against a fitted reference database and print a JSON
    response with cluster assignments and prevalences."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="poppunk_tpu_torch_api",
        description="Assign JSON sketches against a fitted reference "
                    "database (PopPUNK-web flow)")
    parser.add_argument("--sketch", required=True, nargs="+",
                        help="JSON sketch file(s); either a single "
                             "{name: sketch} document or one sketch per "
                             "file (named by file stem)")
    parser.add_argument("--ref-db", required=True,
                        help="Fitted reference database directory")
    parser.add_argument("--output", required=True,
                        help="Output directory for the query database")
    parser.add_argument("--species", default="",
                        help="Species label for alias lookup")
    parser.add_argument("--species-db", default=None,
                        help="Directory holding aliases.csv "
                             "[default = --ref-db]")
    args = parser.parse_args(arg_list)

    sketches = {}
    for path in args.sketch:
        with open(path) as fh:
            doc = json.load(fh)
        # Per-sketch files hold the sketch itself (has sketch keys);
        # a combined document maps names to sketches.
        if any(k in doc for k in ("bbits", "sketchsize64", "version")):
            name = os.path.splitext(os.path.basename(path))[0]
            sketches[name] = doc
        else:
            sketches.update(doc)

    response = assign_sketch_json(sketches, args.ref_db, args.output,
                                  species=args.species,
                                  species_db=args.species_db)
    json.dump(response, sys.stdout, indent=2)
    sys.stdout.write("\n")
    return response


if __name__ == "__main__":
    main()
