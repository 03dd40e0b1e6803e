"""poppunk_tpu_torch — PopPUNK's create-db -> BGMM fit -> assign path in
PyTorch, with a hand-written CUDA kernel for the sketch bin-match popcount.

The JAX package ``poppunk_tpu`` beside it is the frozen reference: module
names here mirror it (``poppunk_tpu/ops/distances.py`` <->
``poppunk_tpu_torch/ops/distances.py``), on-disk formats are the same, and
the tests hold every module against its JAX counterpart. The reference's
JAX-free host modules (sketching, the HDF5 database, QC, pair indexing,
boundary tuples, plotting, the CLI parsers) are imported from it rather
than copied. This package never imports jax.

Devices are explicit: the CLIs resolve ``--gpu-dist`` / ``--gpu-model`` /
``--deviceid`` once (``_device.py``) and pass a ``torch.device`` down.
Without those flags a stage runs on the CPU, with the kernel's plain
PyTorch twin.
"""

__version__ = "0.1.0"
