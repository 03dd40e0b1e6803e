"""poppunk_tpu_torch — PopPUNK's create-db / qc-db -> fit (BGMM, DBSCAN,
refine, threshold, lineage) -> assign path in PyTorch, with hand-written
CUDA kernels for the sketch bin-match popcount.

The JAX package ``poppunk_tpu`` beside it is the frozen reference: module
names here mirror it (``poppunk_tpu/ops/distances.py`` <->
``poppunk_tpu_torch/ops/distances.py``), on-disk formats are the same, and
the tests hold every module against its JAX counterpart. This package
imports nothing of the JAX package and never imports jax: the reference's
host modules it needs (sketching, the HDF5 database, QC, pair indexing,
boundary tuples, the sparse kNN and lineage model, HDBSCAN's host code,
the CLI parsers, the plots it draws) are copies under the same relative
names.

Compute runs on the card, ``cuda:<deviceid>``, unless the caller asks for
the CPU: a library caller by passing ``torch.device("cpu")``, anyone by
setting ``POPPUNK_TPU_TORCH_DEVICE=cpu`` (``_device.py``). On the CPU the
kernels' plain PyTorch twins run. Without CUDA and without that request,
every entry point raises.
"""

__version__ = "0.1.0"

# the JAX package's values (poppunk_tpu/__init__.py), which its sketch
# databases and lineage defaults carry
SKETCH_VERSION = "poppunk-tpu-sketch-1"
SEARCH_DEPTH_FACTOR = 10
DEFAULT_LINEAGE_RESOLUTION = 1e-10
