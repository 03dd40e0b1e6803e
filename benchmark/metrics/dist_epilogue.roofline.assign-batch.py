"""Share of its roofline that dist_epilogue_kernel reaches over the traced typing requests: the least time of the queries x 20,027 pairs they need, over the kernel's summed device time (%)."""

from benchmark import assign_readers


def read(run):
    return assign_readers.epilogue_roofline(run)
