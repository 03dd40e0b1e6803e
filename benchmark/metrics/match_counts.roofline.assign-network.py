"""Share of its roofline that match_counts_kernel reaches over the traced network-mode requests: the least time of the queries x 20,027 pairs they need and of the query pairs of those that classify them, each genome's planes read once a request (once more for the query pairs), over the kernel's summed device time (%)."""

from benchmark import network_readers


def read(run):
    return network_readers.match_counts_roofline(run)
