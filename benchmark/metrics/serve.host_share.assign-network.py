"""Share of the traced network-mode window the host spends in its own time of dists.pack_planes, serve.upload and serve.attach: packing each request's sketches, uploading each bucket through page-locked memory, collecting each dispatch's within-strain pairs (%)."""

from benchmark import assign_readers


def read(run):
    return assign_readers.host_share(run)
