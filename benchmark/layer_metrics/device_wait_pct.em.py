"""Share of the window in the program's device_wait stage: the host
blocked until the card has run a bucket's expectation launches."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "device_wait")
