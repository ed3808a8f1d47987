"""100 x (1 - device busy / traced window), from torch.profiler."""

from benchmark.lib.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
