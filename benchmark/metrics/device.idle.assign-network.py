"""Share of the traced network-mode window in which no kernel, copy or memset runs on the card (%)."""

from benchmark import readers


def read(run):
    return readers.idle(run)
