"""Kernel launches (ops/fb_wavefront.LAUNCHES: every site and both
parts of the stream prep) per megabase of query in the window."""

from benchmark.lib.readers import launches_per_mb


def read(run):
    return launches_per_mb(run)
