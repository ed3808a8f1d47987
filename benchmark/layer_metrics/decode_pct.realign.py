"""Share of the window in the realign CLI's decode stage: per record, the
reweighting and poset filter (or MEA) and the rescoring."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "decode")
