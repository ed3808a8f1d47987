"""Share of the window in the realign CLI's prefetch_wait stage: the main
thread blocked on the worker's next prepared group."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "prefetch_wait")
