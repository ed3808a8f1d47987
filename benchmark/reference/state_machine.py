"""Frozen copy of the port's models/state_machine.py (the numpy
``StateMachine`` and its factories), kept with the benchmark so that no
later change to the program moves the yardstick. It differs from the
original in its imports, in leaving out the engines' ``PairHMM`` module,
and in keeping the parameters in float64 where the program rounds them
to float32.

Cut to the five-state machine, the one the benchmark's configurations
run: its defaults and its loading from a symmetric Hmm. States
(reference impl/stateMachine.c:261-263): match=0, shortGapX=1,
shortGapY=2, longGapX=3, longGapY=4.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.hmm import Hmm, StateMachineType
SYMBOL_NUMBER, SYMBOL_NUMBER_NO_N = 5, 4

LOG_ZERO = -np.inf

MATCH, SHORT_GAP_X, SHORT_GAP_Y, LONG_GAP_X, LONG_GAP_Y = 0, 1, 2, 3, 4

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

    All arrays are float64 numpy here (the program keeps float32). Emission tables are padded to the 5-symbol
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
    f32 = lambda a: np.asarray(a, dtype=np.float64)
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
    if type != StateMachineType.fiveState:
        raise ValueError(f"the reference runs the five-state machine only, not {type}")
    gap = np.full(4, _EMISSION_GAP)
    return _state_machine5_from_constants(type, _default5_constants(),
                                          _default_match_emissions(), gap, gap)


# --------------------------------------------------------------------------
# Loading trained parameters from an Hmm
# --------------------------------------------------------------------------

def _load_match_emissions(hmm: Hmm) -> np.ndarray:
    """log emission probs for the match state, (x,y) averaged with (y,x)
    (reference impl/stateMachine.c:298-317)."""
    e = hmm.emissions[MATCH]
    with np.errstate(divide="ignore"):
        return np.log((e + e.T) / 2.0)


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
    598-604)."""
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
    """A five-state Hmm's StateMachine (reference impl/stateMachine.c:
    797-819, its symmetric five-state branch)."""
    t = hmm.type
    if t != StateMachineType.fiveState:
        raise ValueError(f"the reference runs the five-state machine only, not {t}")
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
    em_match = _load_match_emissions(hmm)
    em_gap = _load_gap_emissions(hmm, [SHORT_GAP_X, LONG_GAP_X], [SHORT_GAP_Y, LONG_GAP_Y])
    return _state_machine5_from_constants(t, c, em_match, em_gap, em_gap)
