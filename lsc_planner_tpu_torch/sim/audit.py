"""Sampled safety audit + metrics (port of lsc_planner_tpu/sim/audit.py).

Every cycle, all trajectories are sampled at the record time step and the
pairwise ellipsoidal (downwash-aware) safety ratios are computed; a ratio
below 1 is a collision (savePlanningResult,
multi_sync_simulator.cpp:446-503).  continuous_safety_ratio checks whole
trajectories exactly in time.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bernstein import curve_pair_min_distance, nchoosek


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


def obstacle_safety_ratio(pos, obs_pos, radius, obs_radius):
    """Agent-vs-dynamic-obstacle safety (multi_sync_simulator.cpp:480-499),
    plain euclidean distance over the summed radii.  pos (N, 3), obs_pos
    (O, 3), radius (N,), obs_radius (O,)."""
    dist = torch.linalg.vector_norm(pos[:, None, :] - obs_pos[None, :, :],
                                    dim=-1)
    return torch.amin(dist / (radius[:, None] + obs_radius[None, :]))


def static_box_safety_ratio(pos, boxes, radius):
    """Agent-vs-static-AABB safety: exact box distance over agent radius
    (the box closest-point form, obstacle.hpp:437-478).  pos (N, 3), boxes
    (B, 6) [min, max], radius (N,)."""
    lo, hi = boxes[:, :3], boxes[:, 3:]
    q = torch.clamp(torch.maximum(lo[None] - pos[:, None],
                                  pos[:, None] - hi[None]), min=0.0)
    dist = torch.linalg.vector_norm(q, dim=-1)               # (N, B)
    return torch.amin(dist / radius[:, None])


def precision_self_check(device=None, coord: float = 148.0,
                         sep: float = 0.43, tol: float = 1e-3) -> float:
    """Assert that positions_at is exact f32 on `device` (the TF32 guard).

    Two constant-position trajectories at +/-coord, `sep` apart along x,
    are sampled in f32 and compared with the f64 numpy recompute.  Returns
    the max abs error; raises AssertionError above `tol`."""
    device = resolve_device(device)
    M, n1, dt = 5, 6, 0.2
    base = np.zeros((2, M, n1, 3), np.float64)
    base[0, ..., 0] = coord
    base[1, ..., 0] = coord + sep
    base[:, ..., 1] = -coord
    base[:, ..., 2] = 1.5
    base[..., 0] += np.linspace(0.0, 0.1, M * n1).reshape(M, n1)
    ts = _sample_times(0.05, 0.2, inclusive=False)
    dev = positions_at(torch.as_tensor(base, dtype=torch.float32,
                                       device=device), ts, dt)
    W = _sample_weight_matrix(ts, dt, M, n1 - 1)
    ref = np.einsum("tmi,nmid->tnd", W, base)
    err = float(np.abs(dev.cpu().double().numpy() - ref).max())
    if not err < tol:
        raise AssertionError(
            f"audit sampling error {err:.4f} m > {tol} on {device}: "
            "positions_at is not exact f32 (TF32 matmul leak); min_safety "
            "values are untrustworthy")
    return err


def continuous_safety_ratio(trajs, radius, downwash):
    """Continuous-time pairwise safety ratio over the whole horizon
    (audit.py:116-140): for every agent pair and segment the minimum of
    the downwash-scaled relative Bernstein curve's norm is found by root
    isolation on <delta, delta'> (distanceBetweenPolys,
    polynomial.hpp:310-413), so no near-miss between samples hides; a
    lower bound of every sampled audit.  trajs (N, M, n+1, 3).  Returns
    the 0-d min over pairs, segments and time of the ellipsoidal distance
    over r_i + r_j."""
    N = trajs.shape[0]
    r_sum = radius[:, None] + radius[None, :]
    dw = (downwash[:, None] * radius[:, None] +
          downwash[None, :] * radius[None, :]) / r_sum        # (N, N)
    rel = trajs[:, None] - trajs[None, :]          # (N, N, M, n+1, 3)
    scale = torch.stack([torch.ones_like(dw), torch.ones_like(dw), 1.0 / dw],
                        dim=-1)                    # (N, N, 3)
    rel = rel * scale[:, :, None, None, :]
    dist, _ = curve_pair_min_distance(rel, torch.zeros_like(rel))
    ratio = dist / r_sum[..., None]                # (N, N, M)
    eye = torch.eye(N, dtype=torch.bool, device=trajs.device)[..., None]
    return torch.where(eye, float("inf"), ratio).amin()
