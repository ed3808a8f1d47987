"""em_iteration_s: the window over the EM iterations it completed."""


def read(run):
    w = run.window
    return w["window_s"] / w["iterations"]
