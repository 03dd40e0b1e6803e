"""Share of its roofline that dist_epilogue_kernel reaches over the traced streaming passes: the least time of the n_real(n_real-1)/2 pairs each pass needs, over the kernel's summed device time (%)."""

from benchmark import stream_readers


def read(run):
    return stream_readers.epilogue_roofline(run)
