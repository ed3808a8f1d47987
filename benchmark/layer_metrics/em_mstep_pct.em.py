"""Share of the window in the EM loop's em_mstep stage: the maximisation
step and the model file."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "em_mstep")
