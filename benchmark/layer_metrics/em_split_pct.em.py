"""Share of the window in the EM loop's em_split stage: splitting the
corpus into jobs and sampling them."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "em_split")
