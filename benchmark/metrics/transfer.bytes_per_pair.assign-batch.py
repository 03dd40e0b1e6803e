"""Bytes uploaded per query x reference pair typed: the bytes counters of the window's serve.upload spans over the queries of its requests x 20,027 (B/pair)."""

from benchmark import assign_readers


def read(run):
    return assign_readers.bytes_per_pair(run)
