"""Share of the window in the align CLI's align_cigar_out stage: per pair,
building its cigar from the decoded pairs and writing it."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "align_cigar_out")
