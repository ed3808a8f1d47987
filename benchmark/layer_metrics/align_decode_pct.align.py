"""Share of the window in the align CLI's align_decode stage: per pair,
the AMAP reweight, the poset filter and the sort of its pairs."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "align_decode")
