"""Within-strain query x reference pairs fetched per query: the summed edges counters of the window's serve.assign spans over their summed queries (edges/query)."""

from benchmark import network_readers


def read(run):
    return network_readers.edges_per_query(run)
