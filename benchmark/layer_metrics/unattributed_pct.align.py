"""Share of the window that the main thread spent outside every program
stage (the window less the staged_main_s counter): each invocation's
argument parsing, fasta reads and model build, and the streaming
engine's host work outside its stages."""

from benchmark.lib.spans import unattributed_pct


def read(run):
    return unattributed_pct(run)
