"""Rows the session computes against the references per query asked in network mode: the summed rows (padded bucket sizes) of the window's serve.dispatch spans over the summed queries of its serve.assign spans (rows/query, at least 1)."""

from benchmark import assign_readers


def read(run):
    return assign_readers.rows_per_query(run)
