"""Sampled safety audit + metrics (port of lsc_planner_tpu/sim/audit.py).

Every cycle, all trajectories are sampled at the record time step and the
pairwise ellipsoidal (downwash-aware) safety ratios are computed; a ratio
below 1 is a collision (savePlanningResult,
multi_sync_simulator.cpp:446-503).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.bernstein import nchoosek


def _sample_times(record_time_step: float, time_step: float,
                  inclusive: bool) -> np.ndarray:
    ts = [0.0]
    t = record_time_step
    while t < time_step - 1e-6:
        ts.append(t)
        t += record_time_step
    if inclusive:
        ts.append(time_step)
    return np.asarray(ts)


def _sample_weight_matrix(ts, dt, M, n) -> np.ndarray:
    """Bernstein sample weights W (T, M, n+1): the position at ts[t] is
    sum_{m,i} W[t, m, i] ctrl[m, i]."""
    ts = np.asarray(ts, np.float64)
    W = np.zeros((len(ts), M, n + 1))
    binom = np.asarray([nchoosek(n, k) for k in range(n + 1)], np.float64)
    for t_i, t in enumerate(ts):
        m = min(max(int(np.floor(t / dt)), 0), M - 1)
        tau = t / dt - m
        i = np.arange(n + 1)
        W[t_i, m] = binom * tau ** i * (1.0 - tau) ** (n - i)
    return W


_weights = {}


def _sample_weights(ts, dt, M, n, dtype, device) -> torch.Tensor:
    """_sample_weight_matrix on the device, made once a (ts, dt, M, n,
    dtype, device), so that no cycle copies it from the host."""
    key = (tuple(float(t) for t in ts), float(dt), M, n, dtype, device)
    if key not in _weights:
        _weights[key] = torch.as_tensor(_sample_weight_matrix(ts, dt, M, n),
                                        dtype=dtype, device=device)
    return _weights[key]


def positions_at(trajs, ts, dt):
    """Positions of all agents at times ts: (T, N, 3).

    The contraction must be exact f32 at |x| ~ 150 m (a bf16 or TF32 pass
    collapses nearby agents onto one point); the matmul runs with TF32 off
    (device.exact_float32), which precision_self_check verifies."""
    M, n1 = trajs.shape[-3], trajs.shape[-2]
    W = _sample_weights(ts, dt, M, n1 - 1, trajs.dtype, trajs.device)
    return torch.einsum("tmi,nmid->tnd", W, trajs)


def pairwise_safety_ratio(pos, radius, downwash):
    """Min over pairs of ellipsoidal distance / (r_i + r_j);
    pos (..., N, 3), radius/downwash (N,)."""
    N = pos.shape[-2]
    r_sum = radius[:, None] + radius[None, :]
    dw = (downwash[:, None] * radius[:, None] +
          downwash[None, :] * radius[None, :]) / r_sum
    delta = pos[..., :, None, :] - pos[..., None, :, :]
    dist = torch.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2 +
                      (delta[..., 2] / dw) ** 2)
    ratio = dist / r_sum
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)
    ratio = torch.where(eye, torch.full_like(ratio, float("inf")), ratio)
    return torch.amin(ratio, dim=(-2, -1))


def step_safety_ratio(trajs, radius, downwash, dt, record_time_step,
                      time_step):
    """Min safety ratio over the record samples of the upcoming step."""
    ts = _sample_times(record_time_step, time_step, inclusive=False)
    pos = positions_at(trajs, ts, dt)
    return torch.amin(pairwise_safety_ratio(pos, radius, downwash))


def step_distance(trajs, dt, record_time_step, time_step):
    """Total swarm path length over the upcoming step (getTotalDistance,
    multi_sync_simulator.cpp:671-680)."""
    ts = _sample_times(record_time_step, time_step, inclusive=True)
    pos = positions_at(trajs, ts, dt)
    return torch.linalg.vector_norm(torch.diff(pos, dim=0), dim=-1).sum()


def static_box_safety_ratio(pos, boxes, radius):
    """Agent-vs-static-AABB safety: exact box distance over agent radius
    (the box closest-point form, obstacle.hpp:437-478).  pos (N, 3), boxes
    (B, 6) [min, max], radius (N,)."""
    lo, hi = boxes[:, :3], boxes[:, 3:]
    q = torch.clamp(torch.maximum(lo[None] - pos[:, None],
                                  pos[:, None] - hi[None]), min=0.0)
    dist = torch.linalg.vector_norm(q, dim=-1)               # (N, B)
    return torch.amin(dist / radius[:, None])


