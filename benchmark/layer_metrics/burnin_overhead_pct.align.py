"""Share of the window batches' launched cells that are no band cell of
a streamed chunk: 100 x (stream_cells_launched - stream_cells_useful) /
stream_cells_launched. The burn-in halo, the padding of each window to
its width bucket and the rows past a chunk's end make up the rest."""


def read(run):
    launched = run.counters.get("stream_cells_launched")
    useful = run.counters.get("stream_cells_useful")
    if not launched or useful is None:
        return None
    return 100.0 * (launched - useful) / launched
