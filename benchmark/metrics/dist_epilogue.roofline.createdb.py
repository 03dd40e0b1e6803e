"""Share of its roofline that dist_epilogue_kernel reaches over the traced create-db passes: the least time of the n(n-1)/2 pairs each pass needs, over the kernel's summed device time (%)."""

from benchmark import readers


def read(run):
    return readers.epilogue_createdb(run)
