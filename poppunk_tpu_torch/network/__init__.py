"""Network layer: strain graphs as edge arrays, on the host.

Host code copied from poppunk_tpu/network (whose package imports jax):
graph, components (native union-find / scipy), summary statistics, cluster
naming, clique-based reference extraction.
"""

from .graph import Graph  # noqa: F401
from .components import connected_components  # noqa: F401
from .summary import network_summary, print_network_summary  # noqa: F401
from .clusters import print_clusters  # noqa: F401
