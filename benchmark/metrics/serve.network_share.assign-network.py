"""Share of the traced network-mode window the host spends in the self time of serve.network: each request's queries joined to the resident database network's components and the touched components named (%)."""

from benchmark import network_readers


def read(run):
    return network_readers.network_share(run)
