"""Share of the window in the program's stream_readback stage: each
streamed chunk's posterior entries copied back from the card and turned
into pairs (the wait for the chunk's kernels is device_wait's)."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "stream_readback")
