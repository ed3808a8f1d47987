"""Share of the window in the program's host_prep stage: band
construction, (P, W) bucketing and the launch inputs, on the host."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "host_prep")
