"""Share of the window in the realign CLI's cigar_in stage: reading and
parsing a group's cigar lines on the main thread."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "cigar_in")
