"""Multi-process initialisation and the pod mesh.

Counterpart of poppunk_tpu/parallel/distributed.py. Wire-up:

- every process calls :func:`init_distributed`, which starts a
  ``torch.distributed`` process group (the ``jax.distributed`` handshake's
  counterpart) from the same environment names;
- :func:`pod_mesh` builds a ('q', 'r') mesh over every process's devices,
  ``r`` within each process and ``q`` across processes (query batches are
  data-parallel; the only cross-process traffic is the tile gather);
- the sharded distance path (parallel/dists.py) takes whatever mesh it is
  given: each rank computes the tiles of the devices it owns.

The tile gather runs on HOST tensors over gloo, as the reference's
``process_allgather`` hands back host numpy. That is why the backend
string names gloo for the CPU; NCCL is named for CUDA tensors, for device
collectives no ported path makes yet, and a communicator is only built by
the first such collective. So two ranks may share one card (NCCL refuses
two ranks on one GPU): the two-process path runs on a single card too.
"""

import os
import sys

import torch

from .mesh import Mesh, gather_devices, mesh_shape_for, process_count
from .mesh import process_index, visible_devices


def _backend():
    """gloo for host tensors, NCCL for CUDA ones; a build without NCCL
    (the CPU wheels) has no CUDA backend to name."""
    if torch.distributed.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Start the process group across processes.

    No-op when single-process (the common case in tests / one-host runs).
    Arguments default from the environment variables COORDINATOR_ADDRESS
    (host:port of rank 0), NUM_PROCESSES and PROCESS_ID, the JAX
    package's names. Returns True when a group was started."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    num_processes = num_processes or _env_int("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int(
        "PROCESS_ID")
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number "
            "of processes and this process's id (COORDINATOR_ADDRESS, "
            "NUM_PROCESSES, PROCESS_ID)")
    address = coordinator_address
    if "://" not in address:
        address = "tcp://" + address
    torch.distributed.init_process_group(
        backend=_backend(), init_method=address,
        world_size=int(num_processes), rank=int(process_id))
    sys.stderr.write(
        f"torch.distributed initialised: process {process_index()} of "
        f"{process_count()}, backend {_backend()}\n")
    return True


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def pod_mesh(n_q=None, devices=None):
    """A ('q', 'r') mesh over ALL processes' devices, r contiguous within
    each process. ``devices``: this process's devices (None: every visible
    card, or the CPU under ``POPPUNK_TPU_TORCH_DEVICE=cpu``; a repeated
    device makes a virtual local mesh). A collective under a process
    group: every rank calls it.

    n_q defaults to the process count, giving each process one query
    shard and an r axis entirely inside it.
    """
    local = visible_devices() if devices is None else devices
    devices, ranks = gather_devices(local)
    n_dev = len(devices)
    if n_q is None:
        n_q = process_count() if n_dev % process_count() == 0 else 1
    if n_dev % n_q != 0:
        raise ValueError(f"n_q={n_q} must divide device count {n_dev}")
    return Mesh(devices, mesh_shape_for(n_dev, n_q), ranks)


def is_primary():
    """True on the process that should write output files."""
    return process_index() == 0
