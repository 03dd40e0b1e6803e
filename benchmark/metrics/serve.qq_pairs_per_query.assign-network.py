"""Query pairs classified per query: the summed qq_pairs counters of the window's serve.assign spans (q(q-1)/2 in a request with a query of no within-strain reference, else 0) over their summed queries (pairs/query)."""

from benchmark import network_readers


def read(run):
    return network_readers.qq_pairs_per_query(run)
