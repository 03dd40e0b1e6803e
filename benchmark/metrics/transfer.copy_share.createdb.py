"""Share of the traced create-db window in which the card runs a host-device copy: the planes' upload and each chunk's fetch (%)."""

from benchmark import readers


def read(run):
    return readers.share(run, ("gpu_memcpy",))
