"""Swarm state and static worlds carried across between the JAX package
and the port.

A JAX ``SwarmState`` converted field by field with ``np.asarray`` becomes
the port's ``SwarmState`` on any device, and back; both sides keep the
same field names and dtypes (int32 counters, bool flags, float rest).  An
ESDF travels as a dict of its fields (dist grid, origin key, resolution,
max_dist, occupancy), which both packages' ``ESDF`` classes take.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .sim.simulator import SwarmState
from .world.esdf import ESDF

_INT_FIELDS = frozenset({"seq", "stall_count", "rescue_phase"})
_BOOL_FIELDS = frozenset({"sfc_initialized", "rescue_active",
                          "slack_flags"})


def state_from_numpy(d: dict, device=None,
                     dtype: torch.dtype = torch.float32) -> SwarmState:
    """dict of numpy arrays (missing or None fields stay None) ->
    SwarmState on `device` (the CUDA device unless another is named),
    floats in `dtype`."""
    device = resolve_device(device)
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


def esdf_from_numpy(d: dict, device=None,
                    dtype: torch.dtype = torch.float32) -> ESDF:
    """dict with dist (X, Y, Z), origin_key (3,), resolution, max_dist and
    occ (or None) -> the port's ESDF with dist on `device` (the CUDA device
    unless another is named) in `dtype`."""
    device = resolve_device(device)
    occ = d.get("occ")
    return ESDF(dist=torch.as_tensor(np.array(d["dist"]), device=device)
                .to(dtype),
                origin_key=np.asarray(d["origin_key"], np.int64),
                resolution=float(d["resolution"]),
                max_dist=float(d["max_dist"]),
                occ=None if occ is None else np.array(occ, bool))


def esdf_to_numpy(esdf) -> dict:
    """An ESDF of either package -> dict of numpy arrays and floats."""
    dist = esdf.dist
    dist = dist.detach().cpu().numpy() if isinstance(dist, torch.Tensor) \
        else np.asarray(dist)
    return {"dist": dist,
            "origin_key": np.asarray(esdf.origin_key, np.int64),
            "resolution": float(esdf.resolution),
            "max_dist": float(esdf.max_dist),
            "occ": None if esdf.occ is None else np.asarray(esdf.occ)}
