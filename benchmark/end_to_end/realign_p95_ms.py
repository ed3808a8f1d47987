"""realign_p95_ms: the 95th percentile, over every record of the window,
of the time from the CLI's read of its cigar line to its write of the
record's cigar."""

import numpy as np


def read(run):
    lat = run.window["latencies_s"]
    return float(np.percentile(lat, 95)) * 1000.0 if len(lat) else None
