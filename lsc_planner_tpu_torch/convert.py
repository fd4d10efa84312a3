"""Swarm state carried across between the JAX package and the port.

A JAX ``SwarmState`` converted field by field with ``np.asarray`` becomes
the port's ``SwarmState`` on any device, and back; both sides keep the
same field names and dtypes (int32 counters, bool flags, float rest).
"""
from __future__ import annotations

import numpy as np
import torch

from .sim.simulator import SwarmState

_INT_FIELDS = frozenset({"seq", "stall_count", "rescue_phase"})
_BOOL_FIELDS = frozenset({"sfc_initialized", "rescue_active",
                          "slack_flags"})


def state_from_numpy(d: dict, device=None,
                     dtype: torch.dtype = torch.float32) -> SwarmState:
    """dict of numpy arrays (missing or None fields stay None) ->
    SwarmState on `device`, floats in `dtype`."""
    fields = {}
    for name in SwarmState._fields:
        v = d.get(name)
        if v is None:
            fields[name] = None
            continue
        t = (torch.int32 if name in _INT_FIELDS else
             torch.bool if name in _BOOL_FIELDS else dtype)
        fields[name] = torch.as_tensor(np.array(v), device=device).to(t)
    return SwarmState(**fields)


def state_to_numpy(state: SwarmState) -> dict:
    """SwarmState -> dict of numpy arrays (None fields stay None)."""
    return {name: (None if v is None else v.detach().cpu().numpy())
            for name, v in state._asdict().items()}
