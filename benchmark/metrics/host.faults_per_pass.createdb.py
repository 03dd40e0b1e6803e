"""Minor page faults per create-db pass: the change in the process's ru_minflt over each of the window's dists.condensed_self_block spans, summed, over the window's passes (faults/pass)."""

from benchmark import program_spans


def read(run):
    return program_spans.faults_per_pass(run)
