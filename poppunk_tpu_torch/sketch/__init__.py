"""Sketching: FASTA/FASTQ ingestion, ntHash rolling hashes, and
BinDash-style b-bit one-permutation MinHash sketches.

This replaces the external pp-sketchlib C++/CUDA library used by the
reference (PopPUNK/sketchlib.py; algorithm lineage documented in
PopPUNK/citation.py:31-43 — BinDash one-permutation MinHash over ntHash).
The implementation here is a from-scratch vectorised redesign, not a port:
hashing is O(L) numpy bit-ops on the host, binning/densification/packing are
array ops, and the packed sketches feed the TPU distance kernels directly.

Copied from ``poppunk_tpu/sketch/__init__.py``, whose counterpart it is:
this package imports nothing of the JAX package.
"""

from .nthash import nthash_canonical, nthash_forward  # noqa: F401
from .minhash import sketch_sequence, SketchParams, Sketch  # noqa: F401
from .reader import read_sequence_input  # noqa: F401
