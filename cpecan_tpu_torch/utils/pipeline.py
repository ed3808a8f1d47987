"""Host/device pipeline overlap.

The CLIs alternate host-side preprocessing (anchoring, subsequence
extraction, cigar parsing) with device batches. jax releases the GIL
while XLA executes, so preparing group i+1 in a worker thread genuinely
overlaps group i's device compute — the framework's answer to the
reference's total lack of intra-process concurrency (SURVEY.md section
2.6 "Pipeline parallelism: none in reference").
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor


def prefetch_map(fn, iterable, depth: int = 1):
    """Yield fn(item) for each item in order, computing up to `depth`
    items ahead in a worker thread. A worker exception propagates to the
    consumer at the corresponding yield."""
    assert depth >= 1
    queue: collections.deque = collections.deque()
    with ThreadPoolExecutor(max_workers=1) as pool:
        try:
            for item in iterable:
                queue.append(pool.submit(fn, item))
                if len(queue) > depth:
                    yield queue.popleft().result()
            while queue:
                yield queue.popleft().result()
        finally:
            for fut in queue:  # consumer bailed early: drop pending work
                fut.cancel()
