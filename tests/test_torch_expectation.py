"""The port's expectation pass against the JAX package on the CPU, and
its CUDA kernel against the plain version on the card.

``exp_reference`` (the plain version of ``_exp_kernel``) is held against
cpecan_tpu's scan engine in expectation mode on the tests/test_fb.py
oracle cases, 5- and 3-state, batched with a zero-length pad pair into
batches of 9 and 6 pairs (not powers of two), and against the naive
full-matrix counts of tests/oracle.py. ``trans``/``emis`` are fp32 sums
taken in another order than XLA's (rtol 1e-4); ``mb``/``total_raw`` come
from the same recursion as the scan engine's (1e-5 absolute).

jax is imported inside the JAX comparisons only, so that the ``cuda``
tests of this file also run where jax is not installed.
"""

import numpy as np
import pytest
import torch

from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu.ops.band import full_band, pad_band
from cpecan_tpu.utils.symbols import encode
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import fb_wavefront
from test_torch_wavefront import _ORACLE, W, _inputs, _tensors

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

P_ORACLE, W_ORACLE = 96, 48
# the tests/test_fb.py expectation fixtures (5- and 3-state)
_EXP_CASES = {5: ("AGCGTT", "AGTTCG"), 3: ("ACGTACGG", "ACTTACGG")}


def _oracle_batch(S):
    """The oracle cases of one state count, full band, plus the
    tests/test_fb.py expectation pair and a zero-length pad pair (the way
    expectation_step pads a bucket), as numpy launch inputs."""
    pairs = [(x, y, rl, rr) for _, (smf, x, y, rl, rr) in sorted(_ORACLE.items())
             if smf().state_number == S]
    pairs.append((*_EXP_CASES[S], False, False))
    n = len(pairs) + 1
    sx = np.zeros((n, P_ORACLE), np.int32)
    sy = np.zeros((n, P_ORACLE), np.int32)
    offs = np.zeros((n, P_ORACLE + 1), np.int32)
    offs[:, 1::2] = 1
    wids = np.ones((n, P_ORACLE + 1), np.int32)
    lx = np.zeros(n, np.int32)
    ly = np.zeros(n, np.int32)
    rl = np.zeros(n, bool)
    rr = np.zeros(n, bool)
    for i, (x, y, l_, r_) in enumerate(pairs):
        offs[i], wids[i], _ = pad_band(full_band(len(x), len(y)), P_ORACLE,
                                       W_ORACLE)
        sx[i, :len(x)] = encode(x)
        sy[i, :len(y)] = encode(y)
        lx[i], ly[i], rl[i], rr[i] = len(x), len(y), l_, r_
    return pairs, (sx, sy, offs, wids, lx, ly, rl, rr)


def _exp_inputs(hmm, args, width, device="cpu"):
    """Stream prep and the forward pass: the exp wrapper's arguments."""
    pre = fb_wavefront.precompute(
        hmm, *[torch.from_numpy(np.asarray(a)).to(device) for a in args],
        width=width)
    t = hmm.t_prob_host
    F, bv, mf = fb_wavefront.fwd(t, pre["ex"], pre["ey"], pre["em"], pre["a"],
                                 pre["b1"], pre["b0"], pre["F0"], hmm.nz)
    adj1, adj2 = fb_wavefront.scale_adjustments(mf)
    exp_args = (t, pre["efx"], pre["efy"], pre["efm"], pre["em"], pre["ex"],
                pre["ey"], F, bv, pre["abw"], pre["c1"], pre["c0"],
                pre["bm1"], pre["bm0"], pre["a"], pre["b1"], pre["b0"],
                pre["pm"], pre["end_row"], adj1, adj2, pre["wx"], pre["wy"],
                hmm.nz)
    bwd_args = (t, pre["efx"], pre["efy"], pre["efm"], pre["em"], F, bv,
                pre["abw"], pre["c1"], pre["c0"], pre["bm1"], pre["bm0"],
                pre["pm"], pre["end_row"], hmm.nz)
    return exp_args, bwd_args


def _rows_1_to_L(x, L):
    return np.concatenate([np.asarray(x[i, 1:L[i] + 1]) for i in range(len(L))])


def test_precompute_symbol_streams_match_jax():
    import jax
    import jax.numpy as jnp
    from cpecan_tpu.ops import fb_wavefront as jax_wf

    args, rl, rr = _inputs(zero_pair=True)
    sm = state_machine5()
    P1 = args[2].shape[1]
    ref = jax.vmap(lambda *a: jax_wf._precompute_one(
        sm.device_params(), *a, width=W, rows=P1))(
            *[jnp.asarray(a) for a in (*args, rl, rr)])
    new = fb_wavefront.precompute(PairHMM.from_state_machine(sm),
                                  *_tensors(args, rl, rr), width=W)
    for k in ("wx", "wy"):
        assert new[k].dtype == torch.int8
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_exp_reference_matches_jax_scan_engine(sm_factory):
    import jax.numpy as jnp
    from cpecan_tpu.ops import fb_batch as jax_fb_batch

    import oracle

    sm = sm_factory()
    pairs, args = _oracle_batch(sm.state_number)
    ref = jax_fb_batch.fb_pass_batch_scan(
        sm.device_params(), *[jnp.asarray(a) for a in args],
        mode="expectation", width=W_ORACLE)
    hmm = PairHMM.from_state_machine(sm)
    exp_args, _ = _exp_inputs(hmm, args, W_ORACLE)
    trans, emis, mb, tot = fb_wavefront.exp_reference(*exp_args)

    # the zero-length pad pair adds exactly 0
    assert not trans[-1].any() and not emis[-1].any()
    np.testing.assert_allclose(trans.sum(0).numpy(), np.asarray(ref["trans"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(emis.sum(0).numpy(), np.asarray(ref["emis"]),
                               rtol=1e-4, atol=1e-6)
    L = args[4] + args[5]
    np.testing.assert_allclose(mb.numpy(), np.asarray(ref["mb"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(_rows_1_to_L(tot, L),
                               _rows_1_to_L(ref["total_raw"], L), rtol=0,
                               atol=1e-5)
    # each real pair against the naive float64 full-matrix counts
    for i, (x, y, rl, rr) in enumerate(pairs):
        trans_o, emis_o, _ = oracle.expectations(sm, x, y, rl, rr)
        np.testing.assert_allclose(trans[i].numpy(), trans_o, atol=2e-3)
        np.testing.assert_allclose(emis[i].numpy(), emis_o, atol=2e-3)


@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_exp_reference_recursion_is_bwd_references(sm_factory):
    hmm = PairHMM.from_state_machine(sm_factory())
    _, args = _oracle_batch(hmm.state_number)
    exp_args, bwd_args = _exp_inputs(hmm, args, W_ORACLE)
    _, _, mb, tot = fb_wavefront.exp_reference(*exp_args)
    _, mb_b, tot_b = fb_wavefront.bwd_reference(*bwd_args)
    assert torch.equal(mb, mb_b) and torch.equal(tot, tot_b)


def test_expectation_mode_sums_pairs_and_slices(monkeypatch):
    """The launcher returns the batch sum of the per-pair counts, the
    same when the F budget cuts the batch into slices."""
    hmm = PairHMM.from_state_machine(state_machine5())
    _, args = _oracle_batch(5)
    tensors = [torch.from_numpy(a) for a in args]
    whole = fb_wavefront.fb_pass_batch_wavefront(
        hmm, *tensors, mode="expectation", width=W_ORACLE)
    assert set(whole) == {"mf", "log_fwd", "mb", "total_raw", "trans", "emis"}
    exp_args, _ = _exp_inputs(hmm, args, W_ORACLE)
    trans, emis, _, _ = fb_wavefront.exp_reference(*exp_args)
    torch.testing.assert_close(whole["trans"], trans.sum(0), rtol=0, atol=0)
    torch.testing.assert_close(whole["emis"], emis.sum(0), rtol=0, atol=0)
    monkeypatch.setattr(fb_wavefront, "_F_BUDGET",
                        3 * (P_ORACLE + 1) * 5 * W_ORACLE * 4)
    sliced = fb_wavefront.fb_pass_batch_wavefront(
        hmm, *tensors, mode="expectation", width=W_ORACLE)
    for k in whole:
        torch.testing.assert_close(sliced[k], whole[k], rtol=1e-6, atol=1e-9,
                                   msg=k)


# --------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sm_factory,width", [
    (state_machine5, W_ORACLE), (state_machine3, W_ORACLE),
    (state_machine5, 544),
    (state_machine5, fb_wavefront.EXP_SHARED_WIDTH + 128),
    (state_machine3, fb_wavefront.MAX_KERNEL_WIDTH)])
def test_exp_kernel_matches_plain_version_on_card(cuda_device, sm_factory,
                                                  width):
    """Width 544 gives the kernel four slots per thread and a ring of
    streams; the two widest run eight slots with the emission accumulators
    in device scratch memory."""
    hmm = PairHMM.from_state_machine(sm_factory())
    _, args = _oracle_batch(hmm.state_number)
    exp_args, bwd_args = _exp_inputs(hmm.to(cuda_device), args, width,
                                     cuda_device)
    fb_wavefront.reset_launch_counts()
    got = fb_wavefront.exp(*exp_args)
    _, mb_k, tot_k = fb_wavefront.bwd(*bwd_args)
    torch.cuda.synchronize()
    assert fb_wavefront.LAUNCHES["exp"] == 1
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in exp_args]
    want = fb_wavefront.exp_reference(*cpu)
    assert not got[0][-1].any() and not got[1][-1].any()
    for g, w_, name in zip(got[:2], want[:2], ("trans", "emis")):
        torch.testing.assert_close(g.cpu(), w_, rtol=1e-5, atol=1e-7, msg=name)
    L = args[4] + args[5]
    for g, w_, k in zip(got[2:], want[2:], ("mb", "total_raw")):
        np.testing.assert_allclose(_rows_1_to_L(g.cpu(), L),
                                   _rows_1_to_L(w_, L), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got[2].cpu().numpy(), mb_k.cpu().numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_rows_1_to_L(got[3].cpu(), L),
                               _rows_1_to_L(tot_k.cpu(), L), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_exp_wrapper_rejects_what_it_cannot_run(cuda_device):
    hmm = PairHMM.from_state_machine(state_machine5()).to(cuda_device)
    _, args = _oracle_batch(5)
    exp_args, _ = _exp_inputs(hmm, args, W_ORACLE, cuda_device)
    with pytest.raises(TypeError):
        fb_wavefront.exp(*exp_args[:21], exp_args[21].long(), *exp_args[22:])
    with pytest.raises(ValueError):
        fb_wavefront.exp(*exp_args[:19], exp_args[19].cpu(), *exp_args[20:])
    # a transition outside the kernels' 5-state structure
    with pytest.raises(ValueError, match="outside the kernels"):
        fb_wavefront.exp(*exp_args[:-1], exp_args[-1] + ((0, 1, 2),))
    # an F halo without the carry in: the entry point refuses the launch
    B, _, S, Wd = exp_args[7].shape
    halo = torch.zeros(B, 2, S, Wd, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        fb_wavefront.exp(*exp_args, halo=halo)
