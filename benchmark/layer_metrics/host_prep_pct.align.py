"""Share of the window in the program's host_prep stage, once a pair:
the chunking, the band of each chunk (about 10^6 diagonals) and the
streaming split, on the host."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "host_prep")
