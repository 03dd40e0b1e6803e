"""Share of its roofline that dist_epilogue_kernel reaches over the traced network-mode requests: the least time of the queries x 20,027 pairs they need and of the query pairs of those that classify them, over the kernel's summed device time (%)."""

from benchmark import network_readers


def read(run):
    return network_readers.epilogue_roofline(run)
