"""setup_s: seconds from the process's start to the window's start:
imports, the kernel library's build or load, the traffic's generation
and the warm-up (for EM, the checked iterations too)."""


def read(run):
    return run.setup_s
