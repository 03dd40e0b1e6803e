"""Multi-device scaling: device meshes, sharded distance tiles, the
multi-process wiring.

Counterpart of poppunk_tpu/parallel: a ``Mesh`` of torch devices laid out
as ('q', 'r'), the reference planes split along ``r``, query batches
data-parallel along ``q``, each device's tile computed by the ported
kernels, and a host gather over gloo across processes. The scale tier's
row-sharded passes (scale.py) take the same mesh.
"""

from .mesh import get_mesh, mesh_shape_for  # noqa: F401
from .dists import (  # noqa: F401
    sharded_pairwise_block,
    sharded_query_dists,
    sharded_self_dists,
)
from .distributed import init_distributed, is_primary, pod_mesh  # noqa: F401
