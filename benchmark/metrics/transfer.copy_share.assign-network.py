"""Share of the traced network-mode window in which the card runs a host-device copy: each bucket's upload of its queries, the fetch of its (nearest, within-strain count) heads and of its compacted within-strain pairs (%)."""

from benchmark import readers


def read(run):
    return readers.share(run, ("gpu_memcpy",))
