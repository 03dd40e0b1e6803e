"""Device mesh construction.

Counterpart of poppunk_tpu/parallel/mesh.py. Axis conventions, as there:

- ``r`` — the reference axis. The packed reference planes are split along
  their genome axis; the tile each device computes covers its reference
  shard.
- ``q`` — the query (data-parallel) axis. Query batches split along it.

JAX's mesh is single-controller: one process drives every device and
``shard_map`` runs the per-device body. Here a ``Mesh`` is a plain object
(the devices as a (q, r) grid, and the process rank that owns each), and a
sharded stage loops over the mesh's devices in order: it enqueues each
device's tile on that device and only then reads results back, so the
asynchronous launches on distinct cards overlap. A device list may repeat
a device (``[cpu] * 8`` in the tests, ``[cuda:0] * 4`` on one card): the
same sharded code then runs on one device, one shard after another, the
port's counterpart of the JAX package's virtual CPU devices. Replicated
operands reach each device by ``Tensor.to(device)``, which returns the
same tensor on a repeated device, so a virtual mesh holds one copy.
"""

import numpy as np
import torch

from .. import _device


class Mesh:
    """Devices laid out as a (q, r) grid, with the process rank that owns
    each. ``shape`` is {"q": n_q, "r": n_r}; ``devices`` an object array
    of ``torch.device``, ``ranks`` an int array of the same shape."""

    def __init__(self, devices, shape, ranks=None):
        q, r = shape
        if len(devices) != q * r:
            raise ValueError(f"{len(devices)} devices do not fill a "
                             f"({q}, {r}) mesh")
        grid = np.empty(q * r, dtype=object)
        grid[:] = [torch.device(d) for d in devices]
        self.devices = grid.reshape(q, r)
        self.shape = {"q": int(q), "r": int(r)}
        own = process_index()
        self.ranks = (np.full((q, r), own, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(q, r))
        self.rank = own
        for dev in self.local_devices():
            # keeps float32 products in full precision on a card
            _device.resolve(dev)

    @property
    def size(self):
        return self.shape["q"] * self.shape["r"]

    def tiles(self):
        """(qi, ri, device) of every device this process owns, in mesh
        order (row-major over (q, r))."""
        return [(qi, ri, self.devices[qi, ri])
                for qi in range(self.shape["q"])
                for ri in range(self.shape["r"])
                if self.ranks[qi, ri] == self.rank]

    def local_devices(self):
        """The devices this process owns, flat in mesh order."""
        return [dev for _, _, dev in self.tiles()]

    def flat(self):
        """Every device, flat in mesh order (device d of a row-sharded
        pass is entry d)."""
        return list(self.devices.reshape(-1))

    def __repr__(self):
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.flat()]}"
                f", ranks={self.ranks.reshape(-1).tolist()})")


def process_index():
    """This process's rank under an initialised process group, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count():
    """The process group's size, 1 without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def visible_devices():
    """This process's compute devices: every visible card, or the CPU when
    ``POPPUNK_TPU_TORCH_DEVICE=cpu`` asks for it. Without CUDA and without
    that request it raises, as ``_device.resolve`` does."""
    dev = _device.resolve(None)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def gather_devices(local):
    """(devices, ranks) over every process: each rank's ``local`` list, in
    rank order, as ``jax.devices()`` is global under ``jax.distributed``.
    A collective (every rank calls it) under a process group; ``local``
    with its own rank otherwise."""
    local = [torch.device(d) for d in local]
    if process_count() == 1:
        return local, [process_index()] * len(local)
    lists = [None] * process_count()
    torch.distributed.all_gather_object(lists, [str(d) for d in local])
    devices, ranks = [], []
    for rank, names in enumerate(lists):
        devices += [torch.device(x) for x in names]
        ranks += [rank] * len(names)
    return devices, ranks


def mesh_shape_for(n_devices, n_q=None):
    """Pick a (q, r) mesh shape for ``n_devices`` devices.

    Default: r gets everything (the reference sketch tensor dominates
    memory); pass n_q to reserve a data-parallel query axis.
    """
    if n_q is None:
        return (1, n_devices)
    if n_devices % n_q != 0:
        raise ValueError(f"n_q={n_q} must divide n_devices={n_devices}")
    return (n_q, n_devices // n_q)


def get_mesh(n_devices=None, n_q=None, devices=None):
    """A Mesh with axes ('q', 'r') over the first ``n_devices`` devices.

    ``devices`` None: every visible card of every process (under an
    initialised process group the list is gathered from all ranks), or
    the CPU under ``POPPUNK_TPU_TORCH_DEVICE=cpu``; without CUDA and
    without that request it raises. ``devices`` given: any list of this
    process's devices, a repeated one included."""
    if devices is None:
        devices, ranks = gather_devices(visible_devices())
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"need {n_devices} devices, have {len(devices)}")
            devices, ranks = devices[:n_devices], ranks[:n_devices]
    else:
        devices = [torch.device(d) for d in devices]
        ranks = None
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, mesh_shape_for(len(devices), n_q), ranks)


def default_device_count():
    """Devices in the default mesh (get_mesh()'s), without building it."""
    if process_count() == 1:
        return len(visible_devices())
    return len(gather_devices(visible_devices())[0])


def pad_to_multiple(n, m):
    return ((n + m - 1) // m) * m


def largest_pow2_divisor(n):
    return n & (-n) if n else 1


def pick_chunk(total, target, align=8):
    """A chunk size <= target that is a multiple of ``align``."""
    c = min(total, target)
    c = max(align, (c // align) * align)
    return c

