"""Bytes moved between host and card per condensed pair delivered: the bytes counters of the window's dists.upload and dists.fetch_copy spans over passes x n(n-1)/2 (B/pair)."""

from benchmark import program_spans


def read(run):
    return program_spans.bytes_per_pair(run)
