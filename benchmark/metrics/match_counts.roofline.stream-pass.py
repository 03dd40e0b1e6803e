"""Share of its roofline that match_counts_kernel reaches over the traced streaming passes: the least time of the n_real(n_real-1)/2 pairs each pass needs, genomes read once a pass, over the kernel's summed device time (%)."""

from benchmark import stream_readers


def read(run):
    return stream_readers.match_counts_roofline(run)
