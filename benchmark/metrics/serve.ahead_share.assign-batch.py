"""Share of the traced typing window's dispatches after a request's first whose bucket was packed while the card still ran the request's previous dispatch: the summed ahead counters of the window's serve.dispatch spans over their summed follows counters (%)."""

from benchmark import dispatch_readers


def read(run):
    return dispatch_readers.ahead_share(run)
