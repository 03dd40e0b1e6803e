"""Bytes moved between host and card per query x reference pair: the bytes counters of the window's serve.upload spans (the queries' planes) and serve.edges spans (each dispatch's nearest and counts, and its compacted within-strain pairs) over the queries of its requests x 20,027 (B/pair)."""

from benchmark import network_readers


def read(run):
    return network_readers.bytes_per_pair(run)
