"""The port's wavefront stream preparation against the JAX package's
``jax.vmap(_precompute_one)`` on the same numpy inputs: ragged flags on
some pairs and a zero-length pad pair included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu.ops import fb_wavefront as jax_wf
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import fb_wavefront
from test_torch_wavefront import W, _inputs, _tensors

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROW_MASKS = ("a", "b1", "b0", "abw", "c1", "c0", "bm1", "bm0")
STREAMS = ("ex", "ey", "em", "efx", "efy", "efm")


def _jax_precompute(params, args, rl, rr):
    P1 = args[2].shape[1]
    fn = jax.vmap(lambda *a: jax_wf._precompute_one(params, *a, width=W,
                                                    rows=P1))
    out = fn(*[jnp.asarray(a) for a in (*args, rl, rr)])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_precompute_matches_jax(sm_factory):
    args, rl, rr = _inputs(zero_pair=True)
    sm = sm_factory()
    ref = _jax_precompute(sm.device_params(), args, rl, rr)
    hmm = PairHMM.from_state_machine(sm)
    new = {k: v.numpy() for k, v in fb_wavefront.precompute(
        hmm, *_tensors(args, rl, rr), width=W).items()}

    for k in ROW_MASKS:  # JAX broadcasts the row-constant masks over W
        assert (ref[k] == ref[k][..., :1]).all(), k
        np.testing.assert_array_equal(new[k], ref[k][..., 0], err_msg=k)
        assert new[k].dtype == np.int8
    np.testing.assert_array_equal(new["pm"], ref["pm"])
    for k in ("xoff", "jlo", "jhi", "L"):
        np.testing.assert_array_equal(new[k], ref[k], err_msg=k)
    for k in STREAMS + ("F0", "end_row"):
        assert new[k].dtype == np.float32
        np.testing.assert_allclose(new[k], ref[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    np.testing.assert_allclose(new["m0log"], ref["m0log"][:, 0], rtol=1e-6,
                               atol=1e-7)
    # the zero-length pair emits nothing and has no posterior slots
    for k in STREAMS:
        assert not new[k][-1].any(), k
    assert not (new["pm"][-1] & 7).any()
