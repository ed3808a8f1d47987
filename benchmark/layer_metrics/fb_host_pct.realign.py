"""Share of the window in fb_pass outside device_wait: the host's part of
the pass (launch inputs, copies, launch wrappers, readback, decode)."""

from benchmark.lib.spans import fb_host_pct


def read(run):
    return fb_host_pct(run)
