"""Share of the window in the program's stream_prep stage: the host's
time in each window batch's stream prep in the parallel engine, which
queues the row and slot kernels' window forms (their device time is in
the trace, wavefront_rows and wavefront_prep)."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "stream_prep")
