"""Share of the traced typing window in which the card runs a host-device copy: each bucket's upload of its queries and the fetch of its (nearest, within) pairs (%)."""

from benchmark import readers


def read(run):
    return readers.share(run, ("gpu_memcpy",))
