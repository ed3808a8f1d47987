"""PairHMM (the port's parameter module) against cpecan_tpu's
StateMachine.device_params(): the same eight tensors whether built from
the numpy StateMachine or carried across from the JAX params."""

import numpy as np
import pytest
import torch

from cpecan_tpu.models.hmm import Hmm, StateMachineType
from cpecan_tpu.models.state_machine import (
    state_machine3, state_machine5, state_machine_from_hmm)
from cpecan_tpu.ops import fb_wavefront as jax_wf
from cpecan_tpu_torch.models.state_machine import PARAM_KEYS, PairHMM
from cpecan_tpu_torch.ops import fb_wavefront

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _loaded(hmm_type):
    def make():
        hmm = Hmm(hmm_type)
        hmm.randomise(np.random.default_rng(3))
        return state_machine_from_hmm(hmm)
    return make


_MODELS = {
    "five_state": state_machine5,
    "three_state": state_machine3,
    "hmm_five_state": _loaded(StateMachineType.fiveState),
    "hmm_three_state_asymmetric": _loaded(StateMachineType.threeStateAsymmetric),
}


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_from_jax_params_equals_from_state_machine(name):
    sm = _MODELS[name]()
    jp = {k: np.asarray(v) for k, v in sm.device_params().items()}
    a = PairHMM.from_jax_params(jp)
    b = PairHMM.from_state_machine(sm)
    assert set(dict(a.named_buffers())) == set(PARAM_KEYS)
    for k in PARAM_KEYS:
        ta, tb = getattr(a, k), getattr(b, k)
        assert ta.dtype == torch.float32
        np.testing.assert_array_equal(ta.numpy(), jp[k], err_msg=k)
        np.testing.assert_array_equal(tb.numpy(), jp[k], err_msg=k)
    assert a.state_number == sm.state_number
    assert a.nz == jax_wf.nonzero_transitions(jp["t"])
    # torch's and numpy's float32 exp may differ in the last bit
    np.testing.assert_allclose(
        a.t_prob_host.numpy(),
        np.exp(jp["t"]).reshape(3 * sm.state_number, sm.state_number),
        rtol=1e-6, atol=0)
    # every model's active transitions fit the kernels' compiled structure
    assert set(a.nz) <= set(fb_wavefront.KERNEL_NZ[a.state_number])


def test_kernel_structures_are_the_default_models():
    for sm in (state_machine5(), state_machine3()):
        t = np.stack([sm.t_x, sm.t_m, sm.t_y])
        assert (fb_wavefront.KERNEL_NZ[sm.state_number]
                == fb_wavefront.nonzero_transitions(t)
                == jax_wf.nonzero_transitions(t))


def test_module_moves_its_buffers():
    hmm = PairHMM.from_state_machine(state_machine5()).to(torch.float64)
    assert hmm.t.dtype == torch.float64
    assert hmm.t_prob_host.dtype == torch.float32
