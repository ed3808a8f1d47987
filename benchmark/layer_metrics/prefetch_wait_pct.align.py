"""Share of the window in the align CLI's prefetch_wait stage: the main
thread blocked on the worker's anchoring. With one pair an invocation
nothing overlaps it, so it holds the whole of that pair's anchoring."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "prefetch_wait")
