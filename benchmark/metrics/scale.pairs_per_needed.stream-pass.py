"""Pairs the streaming passes compute per pair they need: the summed pairs counters of the window's scale.tile spans over passes x n_real(n_real-1)/2 (pairs/pair; n_pad^2 over n_real(n_real-1)/2 for the folded walk)."""

from benchmark import stream_readers


def read(run):
    return stream_readers.pairs_per_needed(run)
