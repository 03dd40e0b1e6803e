"""HDF5 sketch database.

Schema (compatible with the reference, written in PopPUNK/web.py:14-61 and
read in PopPUNK/sketchlib.py:125-142):

    /sketches                     group; attrs: sketch_version, codon_phased
    /sketches/<sample>            group per sample; attrs: kmers (int array),
                                  sketchsize64, bbits, length, missing_bases,
                                  base_freq, reads (optional)
    /sketches/<sample>/<k>        uint64[sketchsize64*bbits] dataset,
                                  attr kmer-size
    /random                       random-match model. attrs: use_rc, model
                                  ("pair-bernoulli-v1"), k_min, k_max;
                                  datasets table_keys/table_values (sample
                                  -> composition cluster), cluster_centroids,
                                  matches/<k> ([n_clusters, n_clusters]
                                  chances) — the reference-style RandomMC
                                  table. Our compute path corrects exactly
                                  per pair (sketch/random_match.py); the
                                  table is for interop.

Functions mirror the reference sketchlib wrapper surface
(PopPUNK/sketchlib.py): createDatabaseDir, getSketchSize,
getKmersFromReferenceDatabase, readDBParams, getSeqsInDb, joinDBs,
removeFromDB, constructDatabase, addRandom.

Copied from ``poppunk_tpu/io/hdf5db.py``, whose counterpart it is: this
package imports nothing of the JAX package.
"""

import os
import sys

import h5py
import numpy as np

from .. import SKETCH_VERSION
from ..sketch.minhash import Sketch, SketchParams, sketch_sequence
from ..sketch.reader import read_sequence_input
from ..utils import db_h5_path, read_rfile

RANDOM_MODEL = "pair-bernoulli-v1"


def create_database_dir(out_prefix, kmers=None):
    """Create DB dir; drop a stale DB whose k-mer range mismatches
    (PopPUNK/sketchlib.py:72-106)."""
    if os.path.isdir(out_prefix):
        db_file = db_h5_path(out_prefix)
        if kmers is not None and os.path.isfile(db_file):
            try:
                with h5py.File(db_file, "r") as db:
                    for sample in db["sketches"]:
                        prev = np.asarray(db["sketches"][sample].attrs["kmers"])
                        # reference direction (sketchlib.py:86-99): keep
                        # only if every previously-calculated k is in the
                        # requested range — a stale superset DB would let
                        # later appends create inconsistent k sets
                        if not set(int(k) for k in prev).issubset(
                                set(int(k) for k in kmers)):
                            sys.stderr.write(f"Removing old database {db_file}\n")
                            os.remove(db_file)
                        break
            except OSError:
                os.remove(db_file)
    else:
        os.makedirs(out_prefix, exist_ok=True)


def write_sketches(db_prefix, sketches, codon_phased=False, overwrite=False):
    """Write/append sketches to ``<prefix>/<basename>.h5``."""
    os.makedirs(db_prefix, exist_ok=True)
    path = db_h5_path(db_prefix)
    if overwrite and os.path.isfile(path):
        os.remove(path)
    with h5py.File(path, "a") as db:
        grp = db.require_group("sketches")
        prev_v = grp.attrs.get("sketch_version")
        if prev_v is not None and str(prev_v) != str(SKETCH_VERSION):
            # restamping would mask a real mixed-version database from
            # join_dbs' version guard
            raise RuntimeError(
                f"database {path} has sketch_version {prev_v}; cannot "
                f"append version {SKETCH_VERSION} sketches")
        grp.attrs["sketch_version"] = SKETCH_VERSION
        grp.attrs["codon_phased"] = codon_phased
        for sk in sketches:
            if sk.name in grp:
                del grp[sk.name]
            s = grp.create_group(sk.name)
            s.attrs["kmers"] = np.array(sorted(sk.usigs.keys()), dtype=np.int32)
            s.attrs["sketchsize64"] = sk.sketchsize64
            s.attrs["bbits"] = sk.bbits
            s.attrs["length"] = sk.length
            s.attrs["missing_bases"] = sk.missing_bases
            s.attrs["base_freq"] = np.asarray(sk.base_freq, dtype=np.float64)
            s.attrs["densified"] = sk.densified
            s.attrs["reads"] = sk.reads
            for k, usigs in sk.usigs.items():
                d = s.create_dataset(str(int(k)), data=usigs.astype(np.uint64))
                d.attrs["kmer-size"] = int(k)
    return path


def read_sketches(db_prefix, names=None, full_path=None):
    """Load sketches (all, or the named subset, in the given order)."""
    path = full_path or db_h5_path(db_prefix)
    out = []
    with h5py.File(path, "r") as db:
        grp = db["sketches"]
        if names is None:
            names = sorted(grp.keys())
        for name in names:
            s = grp[name]
            kmers = [int(k) for k in np.asarray(s.attrs["kmers"])]
            usigs = {k: np.asarray(s[str(k)], dtype=np.uint64) for k in kmers}
            out.append(
                Sketch(
                    name=name,
                    usigs=usigs,
                    sketchsize64=int(s.attrs["sketchsize64"]),
                    bbits=int(s.attrs["bbits"]),
                    length=int(s.attrs["length"]),
                    missing_bases=int(s.attrs["missing_bases"]),
                    base_freq=np.asarray(s.attrs["base_freq"], dtype=np.float64),
                    densified=bool(s.attrs.get("densified", False)),
                    reads=bool(s.attrs.get("reads", False)),
                )
            )
    return out


def get_sketch_size(db_prefix):
    """(sketchsize64, codon_phased); exits on inconsistency
    (PopPUNK/sketchlib.py:109-142)."""
    with h5py.File(db_h5_path(db_prefix), "r") as db:
        codon_phased = bool(db["sketches"].attrs.get("codon_phased", False))
        prev = 0
        for sample in db["sketches"]:
            size = int(db["sketches"][sample].attrs["sketchsize64"])
            if prev == 0:
                prev = size
            elif size != prev:
                raise RuntimeError(f"Inconsistent sketch sizes in database for {sample}")
    return prev, codon_phased


def get_db_kmers(db_prefix):
    """Sorted k-mer lengths in DB (PopPUNK/sketchlib.py:144-168)."""
    with h5py.File(db_h5_path(db_prefix), "r") as db:
        prev = None
        for sample in db["sketches"]:
            kmers = np.sort(np.asarray(db["sketches"][sample].attrs["kmers"]))
            if prev is None:
                prev = kmers
            elif not np.array_equal(kmers, prev):
                raise RuntimeError("Inconsistent k-mer lengths in database")
    if prev is None:
        raise RuntimeError(f"No sketches found in {db_prefix}")
    return prev.astype(int)


def read_db_params(db_prefix):
    """(kmers, sketchsize64, codon_phased) (PopPUNK/sketchlib.py:170-195)."""
    kmers = get_db_kmers(db_prefix)
    size, codon_phased = get_sketch_size(db_prefix)
    return kmers, size, codon_phased


def get_seqs_in_db(db_file):
    """Sample names in a DB h5 file (PopPUNK/sketchlib.py:198-214)."""
    with h5py.File(db_file, "r") as db:
        return list(db["sketches"].keys())


def join_dbs(db1, db2, output, update_random=None, full_names=False):
    """Join two sketch DBs (PopPUNK/sketchlib.py:216-293).

    Writes to ``.tmp.h5`` then renames, as the reference does.
    """
    if not full_names:
        join_prefix = os.path.join(output, os.path.basename(output))
        db1_name = db_h5_path(db1)
        db2_name = db_h5_path(db2)
    else:
        db1_name, db2_name, join_prefix = db1, db2, output

    os.makedirs(os.path.dirname(join_prefix) or ".", exist_ok=True)
    with h5py.File(db1_name, "r") as h1, h5py.File(db2_name, "r") as h2, h5py.File(
        join_prefix + ".tmp.h5", "w"
    ) as hj:
        v1 = h1["sketches"].attrs.get("sketch_version")
        v2 = h2["sketches"].attrs.get("sketch_version")
        if v1 is not None and v2 is not None and v1 != v2:
            raise RuntimeError(
                f"Cannot join sketch databases with different sketch versions: {v1} vs {v2}"
            )
        h1.copy("sketches", hj)
        join_grp = hj["sketches"]
        for dataset in h2["sketches"]:
            join_grp.copy(h2["sketches"][dataset], dataset)
        if update_random is not None:
            strand_preserved = bool(update_random.get("strand_preserved", False)) \
                if isinstance(update_random, dict) else False
            _write_random_group(hj, use_rc=not strand_preserved)
        elif "random" in h1:
            h1.copy("random", hj)
    os.rename(join_prefix + ".tmp.h5", join_prefix + ".h5")


def remove_from_db(db_name, out_name, remove_seqs, full_names=False):
    """Copy a DB excluding the named samples (PopPUNK/sketchlib.py:296-346).

    Writes ``<out>/<basename>.tmp.h5`` (caller renames), as the reference.
    """
    remove_seqs = set(remove_seqs)
    if not full_names:
        db_file = db_h5_path(db_name)
        out_file = os.path.join(out_name, os.path.basename(out_name) + ".tmp.h5")
    else:
        db_file, out_file = db_name, out_name

    with h5py.File(db_file, "r") as h_in, h5py.File(out_file, "w") as h_out:
        if "random" in h_in:
            h_in.copy("random", h_out)
        out_grp = h_out.create_group("sketches")
        for attr, val in h_in["sketches"].attrs.items():
            out_grp.attrs.create(attr, val)
        removed = []
        for dataset in h_in["sketches"]:
            if dataset not in remove_seqs:
                out_grp.copy(h_in["sketches"][dataset], dataset)
            else:
                removed.append(dataset)
    missed = remove_seqs.difference(removed)
    if missed:
        sys.stderr.write("WARNING: Did not find samples to remove:\n\t" + "\t".join(missed) + "\n")
    return out_file


# Number of base-composition clusters for the persisted random-match
# table (pp-sketchlib's RandomMC clusters samples by composition before
# tabulating per-cluster-pair chances).
RANDOM_N_CLUSTERS = 2


def _kmeans_freqs(freqs, n_clusters, n_iter=25, seed=1):
    """Tiny deterministic k-means over base-frequency vectors.

    Returns (assignments uint16[n], centroids float64[n_clusters, 4])."""
    freqs = np.asarray(freqs, dtype=np.float64)
    n = freqs.shape[0]
    n_clusters = min(n_clusters, n)
    rng = np.random.default_rng(seed)
    centroids = freqs[rng.choice(n, size=n_clusters, replace=False)]
    assign = np.zeros(n, dtype=np.int64)
    for it in range(n_iter):
        d2 = ((freqs[:, None, :] - centroids[None, :, :]) ** 2).sum(axis=-1)
        new_assign = d2.argmin(axis=1)
        if np.array_equal(new_assign, assign) and it > 0:
            break
        assign = new_assign
        for c in range(n_clusters):
            members = freqs[assign == c]
            if members.shape[0]:
                centroids[c] = members.mean(axis=0)
    # drop empty clusters (identical base freqs collapse the init
    # centroids) and remap — an empty cluster's mean length is NaN and
    # would be persisted into the random matches table
    used = np.unique(assign)
    if len(used) < n_clusters:
        remap = np.zeros(n_clusters, dtype=np.int64)
        remap[used] = np.arange(len(used))
        assign = remap[assign]
        centroids = centroids[used]
    return assign.astype(np.uint16), centroids


def _write_random_group(db, use_rc=True, klist=None):
    """Persist the random-match model.

    Two layers:
    - marker attrs (model, use_rc) — our compute path corrects exactly
      per pair from stored lengths/base frequencies
      (sketch/random_match.py), so nothing else is *needed*;
    - the reference-style clustered Bernoulli table (pp-sketchlib's
      RandomMC, persisted by its addRandom — PopPUNK/sketchlib.py:
      278-322 copies the group verbatim on join/remove): samples
      k-means-clustered by base composition (`table_keys`/`table_values`),
      per-cluster centroids, and per-k [n_clusters, n_clusters] random
      match chances under `matches/<k>`. pp-sketchlib's exact dataset
      naming is unverifiable in this checkout (source absent — see
      PARITY.md); the layout here follows its documented structure.
    """
    if "random" in db:
        del db["random"]
    grp = db.create_group("random")
    grp.attrs["model"] = RANDOM_MODEL
    grp.attrs["use_rc"] = use_rc

    sketches = db["sketches"]
    names = sorted(sketches.keys())
    if klist is None:
        klist = sorted(int(k) for k in np.asarray(sketches[names[0]].attrs["kmers"]))
    lengths = np.array([sketches[s].attrs["length"] for s in names], dtype=np.float64)
    freqs = np.stack([np.asarray(sketches[s].attrs["base_freq"]) for s in names])

    from ..sketch.random_match import random_jaccard_table

    assign, centroids = _kmeans_freqs(freqs, RANDOM_N_CLUSTERS)
    n_clusters = centroids.shape[0]
    # representative length per cluster (mean member length; clusters are
    # guaranteed non-empty by _kmeans_freqs)
    c_len = np.array([lengths[assign == c].mean() for c in range(n_clusters)])

    grp.attrs["k_min"] = int(min(klist))
    grp.attrs["k_max"] = int(max(klist))
    grp.create_dataset("table_keys",
                       data=np.array(names, dtype=h5py.string_dtype()))
    grp.create_dataset("table_values", data=assign)
    grp.create_dataset("cluster_centroids", data=centroids)
    matches = grp.create_group("matches")
    tables = random_jaccard_table([int(k) for k in klist], c_len,
                                  centroids, use_rc=use_rc)
    for ki, k in enumerate(klist):
        matches.create_dataset(str(int(k)), data=tables[ki])


def add_random(db_prefix, sequence_names=None, klist=None, strand_preserved=False,
               overwrite=False, threads=1):
    """Add random-match chances to the DB (PopPUNK/sketchlib.py:437-473).

    Persists both the marker attrs our exact per-pair correction needs
    and the reference-schema clustered Bernoulli table (see
    _write_random_group).
    """
    with h5py.File(db_h5_path(db_prefix), "r+") as db:
        n = (len(sequence_names) if sequence_names is not None
             else len(db["sketches"].keys()))
        if n <= 2:
            sys.stderr.write(
                "Cannot add random match chances with this few genomes\n")
            return
        if "random" in db and not overwrite:
            sys.stderr.write("Using existing random match chances in DB\n")
            return
        _write_random_group(db, use_rc=not strand_preserved, klist=klist)


def _sketch_one(args):
    # native_threads=1 when running inside the construct_database process
    # pool: the pool already spans the cores across genomes, and letting
    # every worker also fan OpenMP across k-mer lengths oversubscribes
    # (P workers x min(n_k, cores) threads on cores CPUs)
    name, files, params, *rest = args
    native_threads = rest[0] if rest else None
    codes, length, missing, is_reads = read_sequence_input(files)
    return sketch_sequence(name, codes, params, length=length,
                           missing_bases=missing, reads=is_reads,
                           native_threads=native_threads)


def construct_database(assembly_list, klist, sketch_size64, o_prefix, threads=1,
                       overwrite=False, strand_preserved=False, min_count=0,
                       use_exact=False, calc_random=True, codon_phased=False,
                       names=None, sequences=None):
    """Sketch all input samples into a new DB
    (PopPUNK/sketchlib.py:348-434).

    ``assembly_list`` is an rfile path; alternatively pass names/sequences
    directly. Returns the sorted sample names.
    """
    if names is None:
        names, sequences = read_rfile(assembly_list)
    if not names:
        raise RuntimeError(
            f"No samples found in input list {assembly_list}")

    params = SketchParams(
        klist=tuple(int(k) for k in klist),
        sketchsize64=int(sketch_size64),
        use_rc=not strand_preserved,
        codon_phased=codon_phased,
        min_count=min_count,
        exact_counter=use_exact,
    )

    db_file = db_h5_path(o_prefix)
    if os.path.isfile(db_file) and overwrite:
        sys.stderr.write("Overwriting db: " + db_file + "\n")
        os.remove(db_file)

    if threads > 1 and len(names) > 1:
        from multiprocessing import get_context

        jobs = [(n, f, params, 1) for n, f in zip(names, sequences)]
        with get_context("fork").Pool(processes=min(threads, len(jobs))) as pool:
            sketches = pool.map(_sketch_one, jobs)
    else:
        sketches = [_sketch_one((n, f, params, None))
                    for n, f in zip(names, sequences)]

    write_sketches(o_prefix, sketches, codon_phased=codon_phased)
    if calc_random:
        add_random(o_prefix, names, klist, strand_preserved, overwrite=True, threads=threads)
    return names


def get_database_statistics(prefix):
    """(genome_lengths, ambiguous_bases) per sample
    (PopPUNK/sketchlib.py:672-688)."""
    lengths, ambiguous = [], []
    with h5py.File(db_h5_path(prefix), "r") as db:
        for sample in db["sketches"]:
            lengths.append(int(db["sketches"][sample].attrs["length"]))
            ambiguous.append(int(db["sketches"][sample].attrs["missing_bases"]))
    return lengths, ambiguous
