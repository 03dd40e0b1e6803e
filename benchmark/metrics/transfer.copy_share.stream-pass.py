"""Share of the traced streaming-pass window in which the card runs a host-device copy: each pass's upload of the planes and its fetch of the kNN, maxima and band histogram (%)."""

from benchmark import readers


def read(run):
    return readers.share(run, ("gpu_memcpy",))
