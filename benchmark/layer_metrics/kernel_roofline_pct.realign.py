"""The window's least device time, from the useful band cells and the
per-cell cost of each pass (benchmark/roofline), over the profiler's
device time of the wavefront_* kernels."""

from benchmark.lib.readers import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run)
