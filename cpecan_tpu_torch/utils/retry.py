"""Transient-failure retries for device work.

The reference pipeline got failure detection from jobTree, which re-ran a
failed Target up to its retryCount before failing the run
(cPecanEm.py:423-426 checks the failed-job count). The analog here: the
unit of retry is one chunk's expectation pass (the same work a jobTree
`calculateExpectations` target did); the caller accumulates into a
scratch container so a mid-chunk failure never double-counts.
"""

from __future__ import annotations

import logging
import time

log = logging.getLogger("cpecan_tpu_torch")


def run_with_retries(fn, what: str, attempts: int, backoff_s: float = 0.5):
    """Call fn() up to `attempts` times, backing off between failures.
    Re-raises the last exception when every attempt failed."""
    assert attempts >= 1
    for attempt in range(attempts):
        try:
            return fn()
        except KeyboardInterrupt:
            raise
        except Exception:
            if attempt == attempts - 1:
                raise
            log.warning("%s failed (attempt %d/%d); retrying",
                        what, attempt + 1, attempts, exc_info=True)
            time.sleep(backoff_s * (attempt + 1))
