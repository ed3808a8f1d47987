"""Share of the window in the program's host_anchoring stage: k-mer
seeding, chaining and the gap recursion of each pair, on the host."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "host_anchoring")
