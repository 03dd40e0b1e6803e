"""Share of its roofline that match_counts_kernel reaches over the traced typing requests: the least time of the queries x 20,027 pairs they need, each query's and reference's planes read once a request, over the kernel's summed device time (%)."""

from benchmark import assign_readers


def read(run):
    return assign_readers.match_counts_roofline(run)
