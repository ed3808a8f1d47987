"""Pair-HMM parameters as a torch module.

The numpy ``StateMachine`` and its factories are reused from
cpecan_tpu (that module imports jax only inside ``device_params``).
``PairHMM`` holds the eight tensors of ``StateMachine.device_params()``
as float32 buffers, so ``.to(device)`` moves the model like any other
module:

  t            (3, S, S) log transitions [x; m; y]
  em_match     (5, 5) log match emissions (incl. N)
  em_gap_x/y   (5,) log gap emissions
  start, ragged_start, end, ragged_end   (S,) log state vectors
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cpecan_tpu.models.state_machine import (  # noqa: F401  (re-exports)
    StateMachine, state_machine3, state_machine5, state_machine_from_hmm)
from cpecan_tpu_torch.ops.fb_wavefront import nonzero_transitions

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
