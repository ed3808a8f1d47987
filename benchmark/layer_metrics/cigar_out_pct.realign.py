"""Share of the window in the realign CLI's cigar_out stage: per record,
building, checking and writing the output cigar."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "cigar_out")
