"""Share of the window in the program's fb_stream stage: each long chunk
through a streaming engine, from its stream prep to its pairs."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "fb_stream")
