"""Log-space math helpers shared by host (numpy) and device (jax) code.

The reference implements logAdd with a piecewise-cubic lookup accurate to
~1e-3 (impl/pairwiseAligner.c:287-307). On TPU we use the exact
log1p(exp(.)) / jnp.logaddexp — the VPU computes transcendentals at full
fp32 throughput, so the lookup trick buys nothing and the exact form *sets*
the parity tolerance (the C approximation is the less accurate side).
"""

from __future__ import annotations

import numpy as np

LOG_ZERO = -np.inf
LOG_ONE = 0.0

# Threshold below which exp() underflows against the larger operand in the
# reference lookup-based logAdd (impl/pairwiseAligner.c:287). Kept only for
# documentation/tests; device code uses exact logaddexp.
LOG_UNDERFLOW_THRESHOLD = 7.5

# Fixed-point scale for posterior probabilities. Reference
# inc/pairwiseAligner.h:26 (PAIR_ALIGNMENT_PROB_1).
PAIR_ALIGNMENT_PROB_1 = 10_000_000


def log_add(x, y):
    """Exact log(exp(x)+exp(y)) for numpy scalars/arrays, -inf safe."""
    return np.logaddexp(x, y)


def log_sum_exp(values, axis=None):
    arr = np.asarray(values, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        m = np.max(arr, axis=axis, keepdims=True)
        m = np.where(np.isfinite(m), m, 0.0)
        out = np.log(np.sum(np.exp(arr - m), axis=axis, keepdims=True)) + m
    if axis is not None:
        out = np.squeeze(out, axis=axis)
    else:
        out = out.reshape(())
    return out
