"""Share of the window in fb_pass outside device_wait: the host's part of
the pass (the copies to the card, launch wrappers, the readback); the
launch inputs are host_prep's here."""

from benchmark.lib.spans import fb_host_pct


def read(run):
    return fb_host_pct(run)
