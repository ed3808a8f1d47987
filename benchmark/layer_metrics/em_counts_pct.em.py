"""Share of the window in the EM loop's em_counts stage: adding each
bucket's and streamed task's counts and likelihood on the host."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "em_counts")
