"""Share of the traced create-db window that the host spends in its own time of assembling the output: each chunk's row slicing (dists.slice) and the final concatenation (dists.concat), from the program's spans (%)."""

from benchmark import program_spans


def read(run):
    return program_spans.assembly_share(run)
