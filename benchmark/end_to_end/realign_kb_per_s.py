"""realign_kb_per_s: kilobases of the query (second) sequences of the
records whose cigar the CLI wrote in the window, over the window."""


def read(run):
    w = run.window
    return w["query_bases"] / 1000.0 / w["window_s"]
