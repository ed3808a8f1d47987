"""Pair-HMM state machines as dense log-space tensors.

The reference implements cell updates as a virtual `cellCalculate` walking a
hand-coded transition graph (impl/stateMachine.c:450-480 for the 5-state,
:689-714 for the 3-state). The TPU-native design instead expresses a state
machine as three dense SxS log transition matrices — one per anti-diagonal
neighbor class:

  t_x : transitions consuming one X symbol   ("lower"  neighbor, xay-1, xmy-1)
  t_m : transitions consuming a match pair   ("middle" neighbor, xay-2, xmy)
  t_y : transitions consuming one Y symbol   ("upper"  neighbor, xay-1, xmy+1)

plus emission tables and start/end log-prob vectors. Inactive transitions
are -inf, so a single batched matrix contraction per neighbor class
computes the whole cell update — the vectorizable form of the reference's
13-transition callback loop.

States (reference impl/stateMachine.c:261-263):
  5-state: match=0, shortGapX=1, shortGapY=2, longGapX=3, longGapY=4
  3-state: match=0, gapX=1, gapY=2

Counterpart of cpecan_tpu/models/state_machine.py: the numpy
``StateMachine`` and its factories are copied from there, and ``PairHMM``
(below) holds the engines' eight log-space tensors as float32 buffers of
an ``nn.Module``, so ``.to(device)`` moves the model like any other
module:

  t            (3, S, S) log transitions [x; m; y]
  em_match     (5, 5) log match emissions (incl. N)
  em_gap_x/y   (5,) log gap emissions
  start, ragged_start, end, ragged_end   (S,) log state vectors
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from cpecan_tpu_torch.models.hmm import Hmm, StateMachineType
from cpecan_tpu_torch.ops.fb_wavefront import nonzero_transitions
from cpecan_tpu_torch.utils.symbols import SYMBOL_NUMBER, SYMBOL_NUMBER_NO_N

LOG_ZERO = -np.inf

MATCH, SHORT_GAP_X, SHORT_GAP_Y, LONG_GAP_X, LONG_GAP_Y = 0, 1, 2, 3, 4
GAP_X, GAP_Y = 1, 2  # 3-state aliases

# N-symbol emission constants (reference impl/stateMachine.c:351-366)
_LOG_N_GAP = -1.386294361  # log(0.25)
_LOG_N_MATCH = -2.772588722  # log(0.25**2)

# Default emission tables (reference impl/stateMachine.c:269-292): a
# symmetric transition/transversion match model and flat log(0.2) gap probs.
_EMISSION_MATCH = -2.1149196655034745  # log(0.12064298095701059)
_EMISSION_TRANSVERSION = -4.5691014376830479  # log(0.010367271172731285)
_EMISSION_TRANSITION = -3.9833860032220842  # log(0.01862247669752685)
_EMISSION_GAP = -1.6094379124341003  # log(0.2)


@dataclasses.dataclass(frozen=True)
class StateMachine:
    """Dense log-space pair-HMM parameterization.

    All arrays are float32 numpy; ``PairHMM.from_state_machine`` turns
    them into the tensors the DP engines consume. Emission tables are padded to the 5-symbol
    alphabet with the fixed N log-probs so device code never branches on N.
    """

    type: StateMachineType
    t_x: np.ndarray  # (S, S) log transitions consuming X
    t_m: np.ndarray  # (S, S) log transitions consuming a match pair
    t_y: np.ndarray  # (S, S) log transitions consuming Y
    em_match: np.ndarray  # (5, 5) log match emission probs incl. N
    em_gap_x: np.ndarray  # (5,) log gap-X emission probs incl. N
    em_gap_y: np.ndarray  # (5,)
    start: np.ndarray  # (S,) log start-state probs
    ragged_start: np.ndarray  # (S,)
    end: np.ndarray  # (S,) log end-state probs
    ragged_end: np.ndarray  # (S,)

    @property
    def state_number(self) -> int:
        return self.t_m.shape[0]

    @property
    def match_state(self) -> int:
        return MATCH

    @property
    def gap_x_state(self) -> int:
        return GAP_X  # primary (short) gap states, reference :512-513, :736-737

    @property
    def gap_y_state(self) -> int:
        return GAP_Y


def _pad_match_emissions(match4: np.ndarray) -> np.ndarray:
    em = np.full((SYMBOL_NUMBER, SYMBOL_NUMBER), _LOG_N_MATCH, dtype=np.float64)
    em[:SYMBOL_NUMBER_NO_N, :SYMBOL_NUMBER_NO_N] = match4
    return em


def _pad_gap_emissions(gap4: np.ndarray) -> np.ndarray:
    em = np.full((SYMBOL_NUMBER,), _LOG_N_GAP, dtype=np.float64)
    em[:SYMBOL_NUMBER_NO_N] = gap4
    return em


def _default_match_emissions() -> np.ndarray:
    m, v, t = _EMISSION_MATCH, _EMISSION_TRANSVERSION, _EMISSION_TRANSITION
    return np.array(
        [[m, v, t, v],
         [v, m, v, t],
         [t, v, m, v],
         [v, t, v, m]], dtype=np.float64
    )


def _finish(type, t_x, t_m, t_y, em_match4, em_gap_x4, em_gap_y4,
            start, ragged_start, end, ragged_end) -> StateMachine:
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return StateMachine(
        type=type,
        t_x=f32(t_x), t_m=f32(t_m), t_y=f32(t_y),
        em_match=f32(_pad_match_emissions(em_match4)),
        em_gap_x=f32(_pad_gap_emissions(em_gap_x4)),
        em_gap_y=f32(_pad_gap_emissions(em_gap_y4)),
        start=f32(start), ragged_start=f32(ragged_start),
        end=f32(end), ragged_end=f32(ragged_end),
    )


# --------------------------------------------------------------------------
# 5-state machine {match, shortGapX, shortGapY, longGapX, longGapY}
# --------------------------------------------------------------------------

def _state_machine5_from_constants(type: StateMachineType, c: dict,
                                   em_match4, em_gap_x4, em_gap_y4) -> StateMachine:
    S = 5
    t_x = np.full((S, S), LOG_ZERO)
    t_m = np.full((S, S), LOG_ZERO)
    t_y = np.full((S, S), LOG_ZERO)

    # Lower/X transitions (reference impl/stateMachine.c:454-461; note the
    # short/long gap-switch transitions are commented out there and are
    # therefore inactive here too).
    t_x[MATCH, SHORT_GAP_X] = c["gap_short_open_x"]
    t_x[SHORT_GAP_X, SHORT_GAP_X] = c["gap_short_extend_x"]
    t_x[MATCH, LONG_GAP_X] = c["gap_long_open_x"]
    t_x[LONG_GAP_X, LONG_GAP_X] = c["gap_long_extend_x"]

    # Middle/match transitions (:463-469)
    t_m[MATCH, MATCH] = c["match_continue"]
    t_m[SHORT_GAP_X, MATCH] = c["match_from_short_gap_x"]
    t_m[SHORT_GAP_Y, MATCH] = c["match_from_short_gap_y"]
    t_m[LONG_GAP_X, MATCH] = c["match_from_long_gap_x"]
    t_m[LONG_GAP_Y, MATCH] = c["match_from_long_gap_y"]

    # Upper/Y transitions (:471-478)
    t_y[MATCH, SHORT_GAP_Y] = c["gap_short_open_y"]
    t_y[SHORT_GAP_Y, SHORT_GAP_Y] = c["gap_short_extend_y"]
    t_y[MATCH, LONG_GAP_Y] = c["gap_long_open_y"]
    t_y[LONG_GAP_Y, LONG_GAP_Y] = c["gap_long_extend_y"]

    start = np.array([0.0, LOG_ZERO, LOG_ZERO, LOG_ZERO, LOG_ZERO])  # :401-405
    ragged_start = np.array([LOG_ZERO, LOG_ZERO, LOG_ZERO, 0.0, 0.0])  # :407-410
    end = np.array([  # :412-429
        c["match_continue"], c["match_from_short_gap_x"], c["match_from_short_gap_y"],
        c["match_from_long_gap_x"], c["match_from_long_gap_y"],
    ])
    ragged_end = np.array([  # :431-448
        c["gap_long_open_x"], c["gap_long_open_x"], c["gap_long_open_y"],
        c["gap_long_extend_x"], c["gap_long_extend_y"],
    ])
    return _finish(type, t_x, t_m, t_y, em_match4, em_gap_x4, em_gap_y4,
                   start, ragged_start, end, ragged_end)


def _default5_constants() -> dict:
    # Hardcoded default log constants (reference impl/stateMachine.c:484-501)
    c = {
        "match_continue": -0.030064059121770816,
        "match_from_short_gap_x": -1.272871422049609,
        "match_from_long_gap_x": -5.673280173170473,
        "gap_short_open_x": -4.34381910900448,
        "gap_short_extend_x": -0.3388262689231553,
        "gap_long_open_x": -6.30810595366929,
        "gap_long_extend_x": -0.003442492794189331,
    }
    for key in list(c):
        if key.endswith("_x"):
            c[key[:-2] + "_y"] = c[key]
    return c


def state_machine5(type: StateMachineType = StateMachineType.fiveState) -> StateMachine:
    if type not in (StateMachineType.fiveState, StateMachineType.fiveStateAsymmetric):
        raise ValueError(f"Wrong type for five state: {type}")
    gap = np.full(4, _EMISSION_GAP)
    return _state_machine5_from_constants(type, _default5_constants(),
                                          _default_match_emissions(), gap, gap)


# --------------------------------------------------------------------------
# 3-state machine {match, gapX, gapY}
# --------------------------------------------------------------------------

def _state_machine3_from_constants(type: StateMachineType, c: dict,
                                   em_match4, em_gap_x4, em_gap_y4) -> StateMachine:
    S = 3
    t_x = np.full((S, S), LOG_ZERO)
    t_m = np.full((S, S), LOG_ZERO)
    t_y = np.full((S, S), LOG_ZERO)

    # Gap-switch transitions ARE active in the 3-state machine
    # (reference impl/stateMachine.c:695-713).
    t_x[MATCH, GAP_X] = c["gap_open_x"]
    t_x[GAP_X, GAP_X] = c["gap_extend_x"]
    t_x[GAP_Y, GAP_X] = c["gap_switch_to_x"]

    t_m[MATCH, MATCH] = c["match_continue"]
    t_m[GAP_X, MATCH] = c["match_from_gap_x"]
    t_m[GAP_Y, MATCH] = c["match_from_gap_y"]

    t_y[MATCH, GAP_Y] = c["gap_open_y"]
    t_y[GAP_Y, GAP_Y] = c["gap_extend_y"]
    t_y[GAP_X, GAP_Y] = c["gap_switch_to_y"]

    start = np.array([0.0, LOG_ZERO, LOG_ZERO])  # :648-652
    ragged_start = np.array([LOG_ZERO, 0.0, 0.0])  # :654-657
    end = np.array([c["match_continue"], c["match_from_gap_x"], c["match_from_gap_y"]])  # :659-672
    ragged_end = np.array([  # :674-687 (note: arithmetic mean of the LOG opens)
        (c["gap_open_x"] + c["gap_open_y"]) / 2.0,
        c["gap_extend_x"], c["gap_extend_y"],
    ])
    return _finish(type, t_x, t_m, t_y, em_match4, em_gap_x4, em_gap_y4,
                   start, ragged_start, end, ragged_end)


def _default3_constants() -> dict:
    # Reference impl/stateMachine.c:718-726
    return {
        "match_continue": -0.030064059121770816,
        "match_from_gap_x": -1.272871422049609,
        "match_from_gap_y": -1.272871422049609,
        "gap_open_x": -4.21256642,
        "gap_open_y": -4.21256642,
        "gap_extend_x": -0.3388262689231553,
        "gap_extend_y": -0.3388262689231553,
        "gap_switch_to_x": -4.910694825551255,
        "gap_switch_to_y": -4.910694825551255,
    }


def state_machine3(type: StateMachineType = StateMachineType.threeState) -> StateMachine:
    if type not in (StateMachineType.threeState, StateMachineType.threeStateAsymmetric):
        raise ValueError(f"Wrong type for three state: {type}")
    gap = np.full(4, _EMISSION_GAP)
    return _state_machine3_from_constants(type, _default3_constants(),
                                          _default_match_emissions(), gap, gap)


# --------------------------------------------------------------------------
# Loading trained parameters from an Hmm
# --------------------------------------------------------------------------

def _load_match_emissions(hmm: Hmm, symmetric: bool) -> np.ndarray:
    """log emission probs for the match state; symmetric averages (x,y) with
    (y,x) (reference impl/stateMachine.c:298-317)."""
    e = hmm.emissions[MATCH]
    with np.errstate(divide="ignore"):
        if symmetric:
            return np.log((e + e.T) / 2.0)
        return np.log(e)


def _load_gap_emissions(hmm: Hmm, x_gap_states, y_gap_states) -> np.ndarray:
    """Collapse gap-state emission matrices to per-symbol probs, averaging
    over the given states (reference impl/stateMachine.c:319-349)."""
    gap = np.zeros(SYMBOL_NUMBER_NO_N, dtype=np.float64)
    for s in x_gap_states:
        gap += hmm.emissions[s].sum(axis=1)  # collapse to X symbol
    for s in y_gap_states:
        gap += hmm.emissions[s].sum(axis=0)  # collapse to Y symbol
    with np.errstate(divide="ignore"):
        return np.log(gap / gap.sum())


def _maybe_swap_short_long(c: dict, axis: str) -> None:
    """If EM left the short gap state extending longer than the long one,
    swap the short/long parameter groups (reference impl/stateMachine.c:
    544-550 asymmetric, :598-604 symmetric)."""
    if c[f"gap_short_extend_{axis}"] > c[f"gap_long_extend_{axis}"]:
        for stem in ("gap_short_extend", "match_from_short_gap", "gap_short_open"):
            long_stem = stem.replace("short", "long")
            key_s, key_l = f"{stem}_{axis}", f"{long_stem}_{axis}"
            c[key_s], c[key_l] = c[key_l], c[key_s]


def _log_t(hmm: Hmm, i: int, j: int) -> float:
    with np.errstate(divide="ignore"):
        return float(np.log(hmm.transitions[i, j]))


def _log_t_avg(hmm: Hmm, ij1, ij2) -> float:
    with np.errstate(divide="ignore"):
        return float(np.log((hmm.transitions[ij1] + hmm.transitions[ij2]) / 2.0))


def state_machine_from_hmm(hmm: Hmm) -> StateMachine:
    """Factory: Hmm type -> constructed + loaded StateMachine (reference
    impl/stateMachine.c:797-819)."""
    t = hmm.type
    if t == StateMachineType.fiveState:
        c = {}
        c["match_continue"] = _log_t(hmm, MATCH, MATCH)
        c["match_from_short_gap_x"] = _log_t_avg(hmm, (SHORT_GAP_X, MATCH), (SHORT_GAP_Y, MATCH))
        c["match_from_long_gap_x"] = _log_t_avg(hmm, (LONG_GAP_X, MATCH), (LONG_GAP_Y, MATCH))
        c["gap_short_open_x"] = _log_t_avg(hmm, (MATCH, SHORT_GAP_X), (MATCH, SHORT_GAP_Y))
        c["gap_short_extend_x"] = _log_t_avg(hmm, (SHORT_GAP_X, SHORT_GAP_X), (SHORT_GAP_Y, SHORT_GAP_Y))
        c["gap_long_open_x"] = _log_t_avg(hmm, (MATCH, LONG_GAP_X), (MATCH, LONG_GAP_Y))
        c["gap_long_extend_x"] = _log_t_avg(hmm, (LONG_GAP_X, LONG_GAP_X), (LONG_GAP_Y, LONG_GAP_Y))
        _maybe_swap_short_long(c, "x")
        for key in list(c):
            if key.endswith("_x"):
                c[key[:-2] + "_y"] = c[key]
        em_match = _load_match_emissions(hmm, symmetric=True)
        gap_states_x, gap_states_y = [SHORT_GAP_X, LONG_GAP_X], [SHORT_GAP_Y, LONG_GAP_Y]
        em_gap = _load_gap_emissions(hmm, gap_states_x, gap_states_y)
        return _state_machine5_from_constants(t, c, em_match, em_gap, em_gap)

    if t == StateMachineType.fiveStateAsymmetric:
        c = {}
        c["match_continue"] = _log_t(hmm, MATCH, MATCH)
        for axis, sg, lg in (("x", SHORT_GAP_X, LONG_GAP_X), ("y", SHORT_GAP_Y, LONG_GAP_Y)):
            c[f"match_from_short_gap_{axis}"] = _log_t(hmm, sg, MATCH)
            c[f"match_from_long_gap_{axis}"] = _log_t(hmm, lg, MATCH)
            c[f"gap_short_open_{axis}"] = _log_t(hmm, MATCH, sg)
            c[f"gap_short_extend_{axis}"] = _log_t(hmm, sg, sg)
            c[f"gap_long_open_{axis}"] = _log_t(hmm, MATCH, lg)
            c[f"gap_long_extend_{axis}"] = _log_t(hmm, lg, lg)
            _maybe_swap_short_long(c, axis)
        em_match = _load_match_emissions(hmm, symmetric=False)
        em_gap_x = _load_gap_emissions(hmm, [SHORT_GAP_X, LONG_GAP_X], [])
        em_gap_y = _load_gap_emissions(hmm, [], [SHORT_GAP_Y, LONG_GAP_Y])
        return _state_machine5_from_constants(t, c, em_match, em_gap_x, em_gap_y)

    if t == StateMachineType.threeState:
        c = {}
        c["match_continue"] = _log_t(hmm, MATCH, MATCH)
        c["match_from_gap_x"] = _log_t_avg(hmm, (GAP_X, MATCH), (GAP_Y, MATCH))
        c["match_from_gap_y"] = c["match_from_gap_x"]
        c["gap_open_x"] = _log_t_avg(hmm, (MATCH, GAP_X), (MATCH, GAP_Y))
        c["gap_open_y"] = c["gap_open_x"]
        c["gap_extend_x"] = _log_t_avg(hmm, (GAP_X, GAP_X), (GAP_Y, GAP_Y))
        c["gap_extend_y"] = c["gap_extend_x"]
        c["gap_switch_to_x"] = _log_t_avg(hmm, (GAP_Y, GAP_X), (GAP_X, GAP_Y))
        c["gap_switch_to_y"] = c["gap_switch_to_x"]
        em_match = _load_match_emissions(hmm, symmetric=True)
        em_gap = _load_gap_emissions(hmm, [GAP_X], [GAP_Y])
        return _state_machine3_from_constants(t, c, em_match, em_gap, em_gap)

    if t == StateMachineType.threeStateAsymmetric:
        c = {
            "match_continue": _log_t(hmm, MATCH, MATCH),
            "match_from_gap_x": _log_t(hmm, GAP_X, MATCH),
            "match_from_gap_y": _log_t(hmm, GAP_Y, MATCH),
            "gap_open_x": _log_t(hmm, MATCH, GAP_X),
            "gap_open_y": _log_t(hmm, MATCH, GAP_Y),
            "gap_extend_x": _log_t(hmm, GAP_X, GAP_X),
            "gap_extend_y": _log_t(hmm, GAP_Y, GAP_Y),
            "gap_switch_to_x": _log_t(hmm, GAP_Y, GAP_X),
            "gap_switch_to_y": _log_t(hmm, GAP_X, GAP_Y),
        }
        em_match = _load_match_emissions(hmm, symmetric=False)
        em_gap_x = _load_gap_emissions(hmm, [GAP_X], [])
        em_gap_y = _load_gap_emissions(hmm, [], [GAP_Y])
        return _state_machine3_from_constants(t, c, em_match, em_gap_x, em_gap_y)

    raise ValueError(f"Unrecognised hmm type {t}")


def default_state_machine(type: StateMachineType) -> StateMachine:
    if StateMachineType(type).state_number == 5:
        return state_machine5(type)
    return state_machine3(type)


# --------------------------------------------------------------------------
# The engines' parameter module
# --------------------------------------------------------------------------

PARAM_KEYS = ("t", "em_match", "em_gap_x", "em_gap_y", "start",
              "ragged_start", "end", "ragged_end")


class PairHMM(nn.Module):
    """Log-space pair-HMM parameters (buffers) plus the host-side facts the
    engines need without a device round trip: the state count, the
    nonzero-transition triples and the (3S, S) transition probabilities."""

    def __init__(self, params: dict):
        super().__init__()
        for k in PARAM_KEYS:
            self.register_buffer(
                k, torch.tensor(np.asarray(params[k], dtype=np.float32)))
        t = self.t.numpy()
        self.nz = nonzero_transitions(t)
        self.t_prob_host = torch.exp(self.t).reshape(-1, t.shape[-1]).clone()

    @property
    def state_number(self) -> int:
        return int(self.t.shape[-1])

    @classmethod
    def from_state_machine(cls, sm: StateMachine) -> "PairHMM":
        return cls({
            "t": np.stack([sm.t_x, sm.t_m, sm.t_y]),
            "em_match": sm.em_match, "em_gap_x": sm.em_gap_x,
            "em_gap_y": sm.em_gap_y, "start": sm.start,
            "ragged_start": sm.ragged_start, "end": sm.end,
            "ragged_end": sm.ragged_end,
        })

    @classmethod
    def from_jax_params(cls, d: dict) -> "PairHMM":
        """From cpecan_tpu's ``device_params()`` dict, given as numpy
        arrays (how weights carry across in the tests)."""
        return cls({k: np.asarray(d[k]) for k in PARAM_KEYS})
