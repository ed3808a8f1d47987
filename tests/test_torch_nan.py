"""Non-finite values: the backward kernels keep NaN totals as NaN, and
every kernel gives a row whose values hold a NaN the scale 1.

The Pallas bodies mask the total arithmetically (cpecan_tpu/ops/
fb_wavefront.py:522-533): ok = [total > 0], 1/total as ok / (total +
(1 - ok)) and log(total) as log(total + (1 - ok)) * ok, which gives 0
and 0 for a zero total, 0 and inf for an infinite one and NaN for a NaN
one. The port's plain versions do the same (``_bwd_sweep``), and the
CUDA kernels (bwd, exp and the wide backward kernels, cluster and
global-scratch) are held to them on the card.

On the CPU the port's batch engine is held against the JAX package's
scan engine on a model with one NaN parameter, on
tests/test_torch_wavefront.py's batch and shapes (the scan engine's
compile shape of test_matches_jax_scan_engine). The JAX package's Pallas
wavefront is not the reference here: run in interpret mode on the CPU,
its lane-packed pairs share one-hot segment matmuls, and on this batch
it writes total_raw 0 on every row of all three pairs, the pair without
a NaN input included.

Row scales (F4): the JAX package takes a norm row's max with jnp.max,
which propagates NaN, and maps it with jnp.where(m > 0, m, 1)
(cpecan_tpu/ops/fb.py:292-293, :383-384; the Pallas bodies alike), so a
row whose raw values hold a NaN gets the scale 1: mf / mb 0 there, the
row's values NaN times 1. The port's plain versions and every CUDA
kernel follow that rule.
"""

import numpy as np
import pytest
import torch

from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu_torch.models import state_machine as torch_sm
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import fb_batch, fb_wavefront
from test_torch_wavefront import (
    W, _inputs, _tensors, random_bwd_inputs, random_exp_inputs,
    random_fwd_inputs)

torch.set_num_threads(1)

# (rtol, atol) of the finite values: tests/test_torch_wavefront.py's
TOLERANCES = {"total_raw": (1e-4, 2e-5), "log_fwd": (2e-5, 2e-5),
              "post": (1e-3, 2e-5), "counts": (1e-5, 1e-7),
              "mf": (1e-4, 2e-5), "mb": (1e-4, 2e-5)}


def _with_nan(params, where):
    """The parameters with one NaN: the match emission of (N, G) (only
    pairs with an N in x meet it) or the match-to-match transition (every
    pair)."""
    params = {k: np.asarray(v).copy() for k, v in params.items()}
    if where == "em_match":
        params["em_match"][4, 2] = np.nan
    else:
        params["t"][1, 0, 0] = np.nan
    return params


def _nan_params(sm_factory, where):
    """The JAX model's device parameters with one NaN."""
    return _with_nan(sm_factory().device_params(), where)


def _nan_hmm(where):
    """The port's 5-state model with one NaN (no jax needed)."""
    hmm = PairHMM.from_state_machine(torch_sm.state_machine5())
    return PairHMM(_with_nan({k: v.numpy() for k, v in hmm.named_buffers()},
                             where))


@pytest.mark.parametrize("where", ["em_match", "t"])
@pytest.mark.parametrize("sm_factory,mode", [
    (state_machine5, "posterior_all"), (state_machine3, "posterior_match")])
def test_nan_totals_match_jax_scan_engine(sm_factory, mode, where):
    """total_raw (rows 1..L) and log_fwd are NaN exactly where the JAX
    package's scan engine has them, and agree elsewhere."""
    jax = pytest.importorskip("jax")
    from cpecan_tpu.ops import fb_batch as jax_fb_batch

    args, rl, rr = _inputs()
    params = _nan_params(sm_factory, where)
    ref = jax_fb_batch.fb_pass_batch_scan(
        {k: jax.numpy.asarray(v) for k, v in params.items()},
        *[jax.numpy.asarray(a) for a in (*args, rl, rr)], mode=mode, width=W)
    got = fb_batch.fb_pass_batch(PairHMM.from_jax_params(params),
                                 *_tensors(args, rl, rr), mode=mode, width=W)
    L = args[4] + args[5]
    tr, tr_ref = got["total_raw"].numpy(), np.asarray(ref["total_raw"])
    nan_rows = 0
    for i, Li in enumerate(L):
        a, b = tr[i, 1:Li + 1], tr_ref[i, 1:Li + 1]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        nan_rows += int(np.isnan(a).sum())
        np.testing.assert_allclose(a, b, *TOLERANCES["total_raw"],
                                   equal_nan=True)
    np.testing.assert_allclose(got["log_fwd"].numpy(),
                               np.asarray(ref["log_fwd"]),
                               *TOLERANCES["log_fwd"], equal_nan=True)
    assert nan_rows > 0
    if where == "em_match":  # the pair without an N stays finite
        assert np.isfinite(tr[2, 1:L[2] + 1]).all()


@pytest.mark.parametrize("where", ["em_match", "t"])
@pytest.mark.parametrize("sm_factory,mode", [
    (state_machine5, "posterior_all"), (state_machine3, "posterior_match")])
def test_nan_row_scales_match_jax_scan_engine(sm_factory, mode, where):
    """F4: mf and mb (rows 0..L) on a NaN model against the JAX package's
    scan engine. A norm row whose values hold a NaN has the scale 1 in
    both, so mf / mb exactly 0 there (on the "t" model every norm row
    from diagonal 3 on); every row agrees within the tolerances, and none
    is NaN."""
    jax = pytest.importorskip("jax")
    from cpecan_tpu.ops import fb_batch as jax_fb_batch

    args, rl, rr = _inputs()
    params = _nan_params(sm_factory, where)
    ref = jax_fb_batch.fb_pass_batch_scan(
        {k: jax.numpy.asarray(v) for k, v in params.items()},
        *[jax.numpy.asarray(a) for a in (*args, rl, rr)], mode=mode, width=W)
    got = fb_batch.fb_pass_batch(PairHMM.from_jax_params(params),
                                 *_tensors(args, rl, rr), mode=mode, width=W)
    L = args[4] + args[5]
    nan_rows = 0
    for key in ("mf", "mb"):
        a_all, b_all = got[key].numpy(), np.asarray(ref[key])
        for i, Li in enumerate(L):
            a, b = a_all[i, :Li + 1], b_all[i, :Li + 1]
            norm = np.arange(Li + 1) % fb_wavefront.NORM_EVERY \
                == fb_wavefront.NORM_EVERY - 1
            zero = norm & (b == 0)  # a finite row's max is not exactly 1
            np.testing.assert_array_equal(a[zero], 0.0, err_msg=key)
            np.testing.assert_allclose(a, b, *TOLERANCES[key], err_msg=key)
            nan_rows += int(zero.sum())
            if where == "t":
                assert zero[3:].sum() == norm[3:].sum(), (key, i)
    assert nan_rows > 0


def _nan_rows(inputs, kernel):
    """F4's inputs: one NaN in pair 0's raw values on a norm row (fwd: ex
    at slot 5 of the highest norm row in 1..8, so raw F has a NaN there
    and on every row after; bwd and exp: efx at slot 5 of the highest norm
    row below R - 2, so raw B has a NaN there and on every row below, with
    each pair's at-end row moved to R - 1, or R - 2 where R - 1 rescales).
    Returns (arguments, keywords, the NaN row, the norm rows to check: all
    of them, below the at-end row for bwd and exp)."""
    args, kw = inputs
    args = list(args)
    k0 = kw.get("k0", 0)
    R = args[1].shape[1]
    is_norm = lambda i: (k0 + i) % fb_wavefront.NORM_EVERY \
        == fb_wavefront.NORM_EVERY - 1
    if kernel == "fwd":
        row = max(i for i in range(1, 9) if is_norm(i))
        checked = [i for i in range(R) if is_norm(i)]
    else:
        row = max(i for i in range(R - 2) if is_norm(i))
        end = R - 1 if not is_norm(R - 1) else R - 2
        pmi = 12 if kernel == "bwd" else 17
        pm = args[pmi].clone()
        pm &= ~8
        pm[:, end] |= 8
        args[pmi] = pm
        checked = [i for i in range(end) if is_norm(i)]
    x = args[1].clone()
    x[0, row, 5] = float("nan")
    args[1] = x
    return args, kw, row, checked


# where each kernel's outputs hold its row scales (mf or mb)
_SCALE = {"fwd": 2, "bwd": 1, "exp": 2}


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("kernel", ["fwd", "bwd", "exp"])
def test_plain_versions_give_nan_rows_scale_one(kernel, window):
    """F4 in the plain versions: a NaN in a norm row's raw F (fwd) or raw
    B (bwd, exp) gives the row the scale 1, so mf / mb is exactly 0 there
    and on the norm rows the NaN reaches (after it forward, below it
    backward), the row keeps its NaN (times 1), and the other pair and
    the rows the NaN does not reach keep scales of their own."""
    hmm = PairHMM.from_state_machine(torch_sm.state_machine5())
    args, kw, row, norm = _nan_rows(
        _inputs_for(kernel, hmm, 2, 17, 24, window, 1), kernel)
    out = getattr(fb_wavefront, f"{kernel}_reference")(*args, **kw)
    scale = out[_SCALE[kernel]]
    reached = [i for i in norm if (i >= row if kernel == "fwd" else i <= row)]
    others = [i for i in norm if i not in reached]
    assert row in reached
    assert scale[0, reached].eq(0).all(), scale[0]
    assert scale[0, others].ne(0).all() and scale[1, norm].ne(0).all()
    assert not scale.isnan().any()
    if kernel == "fwd":
        assert out[0][0, row].isnan().any()
        assert torch.isfinite(out[0][1]).all()
    else:
        tot = out[2 if kernel == "bwd" else 3]
        assert tot[0, row].isnan() and torch.isfinite(tot[1, :row + 1]).all()


def _special_totals(inputs, kernel):
    """Row 3: F zero and no bridge (total 0); row 7: one F value inf
    (total inf); row 11: one F value NaN (total NaN). ``inputs`` are
    random_bwd_inputs' or random_exp_inputs' (arguments, keywords)."""
    args, kw = inputs
    Fi, pmi = (5, 12) if kernel == "bwd" else (7, 17)
    F, pm = args[Fi].clone(), args[pmi].clone()
    F[:, 3] = 0.0
    pm[:, 3] &= ~16
    F[:, 7, 1, 5] = float("inf")
    F[:, 11, 0, 9] = float("nan")
    args = list(args)
    args[Fi], args[pmi] = F, pm
    return args, kw


def _inputs_for(kernel, hmm, B, R, Wd, window, seed):
    rng = np.random.default_rng(seed)
    if kernel == "fwd":  # windows at k0 = 6
        return random_fwd_inputs(rng, hmm, B, R, Wd, window)
    if kernel == "bwd":
        got = random_bwd_inputs(rng, hmm, B, R, Wd, carry=window)
        args, carry = got if window else (got, None)
        return ([*args, "posterior_all"],
                {"carry": carry, "k0": 5} if window else {})
    args, kw = random_exp_inputs(rng, hmm, B, R, Wd, window)
    if window:
        kw["k0"] = 3
    return args, kw


def _assert_same(got, want, kernel, what, totals=True):
    """Every output: NaN and inf where the plain version has them, the
    finite values within TOLERANCES (mb, a max, and the carries as the
    kernel tests hold them); fwd's bit for bit. With ``totals``, the
    totals of _special_totals' rows 3, 7 and 11 are 0, inf and NaN."""
    if kernel == "fwd":
        flat = lambda o: list(o[:3]) + list(o[3] if len(o) > 3 else [])
        for g, w in zip(flat(got), flat(want)):
            g, w = g.cpu(), w.cpu()
            assert torch.equal(g.isnan(), w.isnan()), what
            assert torch.equal(g.nan_to_num(), w.nan_to_num()), what
        return
    if kernel == "bwd":
        pairs = [("post", g, w) for g, w in zip(got[0], want[0])]
        pairs += [("mb", got[1], want[1]), ("total_raw", got[2], want[2])]
    else:
        pairs = [("counts", got[0], want[0]), ("counts", got[1], want[1]),
                 ("mb", got[2], want[2]), ("total_raw", got[3], want[3])]
    tot = next(g for key, g, _ in pairs if key == "total_raw")
    assert not totals or (tot[:, 3].eq(0).all() and tot[:, 7].isposinf().all()
                          and tot[:, 11].isnan().all()), what
    for key, g, w in pairs:
        g, w = g.cpu(), w.cpu()
        assert torch.equal(g.isnan(), w.isnan()), (what, key)
        assert torch.equal(g.isinf(), w.isinf()), (what, key)
        rtol, atol = TOLERANCES.get(key, (0.0, 1e-5))
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                   equal_nan=True, msg=f"{what} {key}")


@pytest.mark.parametrize("kernel", ["bwd", "exp"])
def test_plain_versions_mask_totals(kernel):
    """The plain versions, which the kernels are held to: a zero total
    writes total_raw 0 and zero posteriors, an infinite one inf, a NaN
    one NaN (and NaN where it reaches the posteriors or counts)."""
    hmm = PairHMM.from_state_machine(torch_sm.state_machine5())
    args, kw = _special_totals(
        _inputs_for(kernel, hmm, 2, 17, 24, False, 1), kernel)
    out = getattr(fb_wavefront, f"{kernel}_reference")(*args, **kw)
    tot = out[2] if kernel == "bwd" else out[3]
    assert tot[:, 3].eq(0).all()
    assert tot[:, 7].isposinf().all()
    assert tot[:, 11].isnan().all()
    others = [k for k in range(17) if k not in (3, 7, 11)]
    assert torch.isfinite(tot[:, others]).all()
    if kernel == "bwd":
        assert not out[0][0][:, 3].any()
        assert out[0][0][:, 11].isnan().any()
    else:
        assert out[0].isnan().any()


def test_debug_names_the_non_finite_total_on_cpu(monkeypatch):
    """CPECAN_TPU_DEBUG=1 on a NaN transition: the first invariant to
    fail is the per-diagonal total's."""
    args, rl, rr = _inputs()
    hmm = _nan_hmm("t")
    monkeypatch.setenv("CPECAN_TPU_DEBUG", "1")
    with pytest.raises(RuntimeError,
                       match="fb debug: non-finite per-diagonal total"):
        fb_batch.fb_pass_batch(hmm, *_tensors(args, rl, rr),
                               mode="posterior_match", width=W)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("Wd,cluster", [(128, None), (4224, 8), (4224, 0)])
@pytest.mark.parametrize("kernel", ["fwd", "bwd", "exp"])
def test_kernels_keep_non_finite_totals_on_card(cuda_device, kernel, Wd,
                                                cluster, window):
    """The kernels (shared-memory variants at W=128; at W=4224 the wide
    kernels' cluster variant and, with the cluster limit 0, their
    global-scratch one) against their plain versions: bwd and exp on rows
    whose total is 0, inf and NaN, and all three on F4's NaN rows. mf and
    mb are compared bit for bit where the plain version's is 0 (the NaN
    rows and every row without a rescale), fwd's outputs bit for bit
    everywhere, the rest as _assert_same holds them."""
    hmm = PairHMM.from_state_machine(torch_sm.state_machine5())
    cases = []
    if kernel != "fwd":
        cases.append(("totals", _special_totals(
            _inputs_for(kernel, hmm, 2, 17, Wd, window, Wd), kernel)))
    args, kw, _, _ = _nan_rows(
        _inputs_for(kernel, hmm, 2, 17, Wd, window, Wd + 1), kernel)
    cases.append(("nan rows", (args, kw)))
    dev = lambda a: a.to(cuda_device) if torch.is_tensor(a) else a
    for case, (args, kw) in cases:
        args = [args[0]] + [dev(a) for a in args[1:]]
        kw = {k: tuple(map(dev, v)) if isinstance(v, tuple) else dev(v)
              for k, v in kw.items()}
        before = None
        if cluster is not None:
            before = fb_wavefront.set_cluster_limit(cluster)
        try:
            if cluster is not None:
                plan = (fb_wavefront.fwd_wide_plan(5, Wd) if kernel == "fwd"
                        else fb_wavefront.back_wide_plan(5, Wd, kernel == "exp"))
                assert plan["cluster"] == cluster
            got = getattr(fb_wavefront, kernel)(*args, **kw)
            torch.cuda.synchronize()
        finally:
            if before is not None:
                fb_wavefront.set_cluster_limit(before)
        want = getattr(fb_wavefront, f"{kernel}_reference")(*args, **kw)
        what = f"{kernel} {case} W={Wd} cluster={cluster} window={window}"
        _assert_same(got, want, kernel, what, totals=case == "totals")
        g, w = got[_SCALE[kernel]].cpu(), want[_SCALE[kernel]].cpu()
        zero = w == 0
        assert torch.equal(g[zero], w[zero]), what
        if case == "nan rows":
            assert zero[0].sum() > zero[1].sum(), what  # the NaN rows


@pytest.mark.cuda
@pytest.mark.parametrize("Wd", [W, 4224])
def test_debug_names_the_non_finite_total_on_card(cuda_device, monkeypatch,
                                                  Wd):
    """CPECAN_TPU_DEBUG=1 on a NaN transition raises on the card what it
    raises on the CPU (at W=4224 through the cluster kernel)."""
    from test_torch_wavefront import _random_batch

    args = _random_batch(np.random.default_rng(42), W=Wd)
    B = len(args[0])
    rl, rr = np.arange(B) % 3 == 1, np.arange(B) % 3 == 2
    hmm = _nan_hmm("t")
    monkeypatch.setenv("CPECAN_TPU_DEBUG", "1")
    with pytest.raises(RuntimeError,
                       match="fb debug: non-finite per-diagonal total"):
        fb_batch.fb_pass_batch(hmm.to(cuda_device),
                               *_tensors(args, rl, rr, cuda_device),
                               mode="posterior_match", width=Wd)
