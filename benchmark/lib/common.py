"""Small helpers the drivers share."""

from __future__ import annotations

import torch


def sync(device) -> None:
    """Wait for the card, where the device is one."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def model_of(sm) -> dict:
    """The reference DP's model dict of a (reference) state machine."""
    return {k: getattr(sm, k) for k in (
        "t_x", "t_m", "t_y", "em_match", "em_gap_x", "em_gap_y", "start",
        "ragged_start", "end", "ragged_end")}
