"""The port's debug and tracing aids on the CPU.

CPECAN_TPU_DEBUG=1: the four invariants of cpecan_tpu/ops/fb.py's
checkify mode, checked on fb_batch.fb_pass_batch's outputs, on
tests/test_fb.py:174-240's pairs and shapes (P=64, W=32, full band). A
healthy pair gives exactly the unchecked outputs; a NaN transition
raises RuntimeError("fb debug: ...") in the port where the JAX package
raises checkify.JaxRuntimeError on the same inputs.

utils/metrics: ``trace()`` writes a torch.profiler trace, and
``report_lines()`` ends with the kernel launch counts."""

import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from cpecan_tpu.models.state_machine import state_machine5
from cpecan_tpu.ops import fb as jax_fb
from cpecan_tpu.ops.band import full_band, pad_band
from cpecan_tpu.utils.symbols import encode, evolve_sequence, get_random_sequence
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import fb_batch, fb_wavefront
from cpecan_tpu_torch.utils import metrics

torch.set_num_threads(1)

P, W = 64, 32


def _pair_arrays(x, y):
    """One padded full-band pair as numpy arrays (test_fb.py's layout)."""
    band = full_band(len(x), len(y))
    offsets, widths, _L = pad_band(band, P, W)
    sx = np.zeros(P, np.int32)
    sy = np.zeros(P, np.int32)
    sx[:len(x)] = encode(x)
    sy[:len(y)] = encode(y)
    return sx, sy, offsets, widths


def _batch(x, y, pad_rows=0):
    """The pair as a port batch, plus pad_rows zero-length pairs."""
    sx, sy, offsets, widths = _pair_arrays(x, y)
    B = 1 + pad_rows
    cols = [np.zeros((B, P), np.int32), np.zeros((B, P), np.int32),
            np.zeros((B, P + 1), np.int32), np.ones((B, P + 1), np.int32)]
    cols[2][:, 1::2] = 1
    for c, v in zip(cols, (sx, sy, offsets, widths)):
        c[0] = v
    lens = [np.zeros(B, np.int32), np.zeros(B, np.int32)]
    lens[0][0], lens[1][0] = len(x), len(y)
    return [torch.from_numpy(a) for a in
            (*cols, *lens, np.zeros(B, bool), np.zeros(B, bool))]


def _healthy():
    rng = random.Random(2)
    x = get_random_sequence(24, rng).upper()
    y = evolve_sequence(x, rng).upper() or "ACGT"
    return x, y


@pytest.mark.parametrize("mode", ["posterior_match", "posterior_all",
                                  "expectation", "forward"])
def test_debug_mode_passes_on_valid_input(mode, monkeypatch):
    """A healthy pair (and a pad row beside it): every invariant holds and
    the outputs are exactly the unchecked call's."""
    hmm = PairHMM.from_state_machine(state_machine5())
    args = _batch(*_healthy(), pad_rows=1)
    monkeypatch.delenv("CPECAN_TPU_DEBUG", raising=False)
    plain = fb_batch.fb_pass_batch(hmm, *args, mode=mode, width=W)
    monkeypatch.setenv("CPECAN_TPU_DEBUG", "1")
    checked = fb_batch.fb_pass_batch(hmm, *args, mode=mode, width=W)
    assert plain.keys() == checked.keys()
    for k in plain:
        assert torch.equal(plain[k], checked[k]), k


def test_debug_mode_catches_corrupt_params(monkeypatch):
    """A NaN transition (t[1, 0, 0], match to match): the port raises
    'fb debug' where the JAX package's checkify mode does."""
    rng = random.Random(3)
    x = get_random_sequence(20, rng).upper()
    params = {k: np.asarray(v) for k, v in
              state_machine5().device_params().items()}
    params["t"] = params["t"].copy()
    params["t"][1, 0, 0] = np.nan
    monkeypatch.setenv("CPECAN_TPU_DEBUG", "1")

    hmm = PairHMM.from_jax_params(params)
    assert (1, 0, 0) in hmm.nz  # NaN is not a structural zero
    with pytest.raises(RuntimeError, match="fb debug"):
        fb_batch.fb_pass_batch(hmm, *_batch(x, x), mode="posterior_match",
                               width=W)

    sx, _, offsets, widths = _pair_arrays(x, x)
    with pytest.raises(checkify.JaxRuntimeError, match="fb debug"):
        jax_fb.fb_pass({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(sx), jnp.asarray(sx), jnp.asarray(offsets),
                       jnp.asarray(widths), np.int32(len(x)),
                       np.int32(len(x)), False, False,
                       mode="posterior_match", width=W)


def _corrupt_total_nan(out):
    out["total_raw"][0, 5] = float("nan")


def _corrupt_total_drift(out):
    out["total_raw"][0, 5] += 2.0


def _corrupt_posterior(out):
    out["post_match"][0, 10, 3] = 1.01


@pytest.mark.parametrize("corrupt,message", [
    (_corrupt_total_nan, "non-finite per-diagonal total"),
    (_corrupt_total_drift, "per-diagonal totals drift > 1 nat"),
    (_corrupt_posterior, "match posterior > 1")])
def test_each_invariant_raises(corrupt, message):
    """Each check on outputs broken in its own way; a pad row's values
    (beyond its L = 0) are never checked."""
    hmm = PairHMM.from_state_machine(state_machine5())
    x, y = _healthy()
    args = _batch(x, y, pad_rows=1)
    out = fb_batch.fb_pass_batch(hmm, *args, mode="posterior_match", width=W)
    lx, ly = args[4], args[5]
    out["total_raw"][1] = float("nan")  # the pad row
    fb_batch.check_invariants(out, lx, ly)
    corrupt(out)
    with pytest.raises(RuntimeError, match=f"fb debug: {message}"):
        fb_batch.check_invariants(out, lx, ly)


def test_unset_debug_runs_no_check(monkeypatch):
    def fail(*_a):
        raise AssertionError("check ran with CPECAN_TPU_DEBUG unset")

    monkeypatch.delenv("CPECAN_TPU_DEBUG", raising=False)
    monkeypatch.setattr(fb_batch, "check_invariants", fail)
    hmm = PairHMM.from_state_machine(state_machine5())
    fb_batch.fb_pass_batch(hmm, *_batch(*_healthy()), mode="posterior_match",
                           width=W)
    monkeypatch.setenv("CPECAN_TPU_DEBUG", "0")
    fb_batch.fb_pass_batch(hmm, *_batch(*_healthy()), mode="posterior_match",
                           width=W)


def test_trace_writes_a_profiler_trace(tmp_path):
    hmm = PairHMM.from_state_machine(state_machine5())
    with metrics.trace(str(tmp_path)):
        fb_batch.fb_pass_batch(hmm, *_batch(*_healthy()),
                               mode="posterior_match", width=W)
    [path] = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]


def test_report_lines_end_with_the_kernel_launches(monkeypatch):
    launches = dict.fromkeys(fb_wavefront.LAUNCHES, 0)
    launches.update(fwd=3, exp=2, seg_exp=1)
    monkeypatch.setattr(fb_wavefront, "LAUNCHES", launches)
    line = metrics.report_lines()[-1]
    assert line.startswith("kernel_launches: fwd=3 bwd=0 exp=2 ")
    assert "seg_exp=1" in line.split()
    assert len(line.split()) == 1 + len(launches)
