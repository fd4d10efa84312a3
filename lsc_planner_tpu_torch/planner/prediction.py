"""Obstacle prediction / initial trajectory (port of
lsc_planner_tpu/planner/prediction.py: the previous-solution shift, the
constant-velocity and constant-position trajectories, and the slow-down of
the linear prediction modes)."""
from __future__ import annotations

import numpy as np
import torch


def shift_previous_solution(traj: torch.Tensor) -> torch.Tensor:
    """Shift a piecewise trajectory one segment ahead, holding the endpoint
    (obstaclePredictionWithPrevSol traj_planner.cpp:848-858).
    traj: (..., M, n+1, 3)."""
    hold = traj[..., -1:, -1:, :].expand(traj[..., -1:, :, :].shape)
    return torch.cat([traj[..., 1:, :, :], hold], dim=-3)


def constant_velocity_traj(pos, vel, M: int, n: int, dt: float):
    """Control point (m, i) at pos + vel (m + i/n) dt; (..., 3) ->
    (..., M, n+1, 3)."""
    m = torch.arange(M, dtype=pos.dtype, device=pos.device)[:, None]
    i = torch.arange(n + 1, dtype=pos.dtype, device=pos.device)[None, :]
    tau = (m + i / n) * dt
    return pos[..., None, None, :] + vel[..., None, None, :] * \
        tau[..., :, :, None]


def constant_position_traj(pos, M: int, n: int):
    """Every control point at the current position
    (obstaclePredictionWithCurrPos traj_planner.cpp:796-807);
    (..., 3) -> (..., M, n+1, 3)."""
    return pos[..., None, None, :].expand(*pos.shape[:-1], M, n + 1, 3)


def linear_prediction_slowdown(init, obs_pred, agent_radius, obs_radius,
                               obs_mask, horizon, esdf=None,
                               search_step: float = 0.1, eps: float = 1e-6):
    """Slow-down factor of the linear prediction modes (generateLSC
    preamble, traj_planner.cpp:1310-1330): when a predicted straight-line
    motion collides within the horizon, the initial and predicted
    trajectories are contracted toward their starts by
    alpha = (t_min_collision - eps) / horizon.

    init (L, M, n+1, 3); obs_pred (L, O, M, n+1, 3); agent_radius (L,);
    obs_radius, obs_mask (L, O).  Per agent: its path against every
    obstacle path, obstacle pairs (j < k) in its own view, and, with an
    esdf, its path against the static map sampled every search_step.
    Returns alpha (L,) in [0, 1]."""
    from ..ops import geometry as geo
    inf = float("inf")
    a_start = init[:, 0, 0, :]
    a_end = init[:, -1, -1, :]
    o_start = obs_pred[:, :, 0, 0, :]                  # (L, O, 3)
    o_end = obs_pred[:, :, -1, -1, :]

    t_ao = geo.collision_time_linear(
        o_start, o_end, a_start[:, None], a_end[:, None],
        agent_radius[:, None] + obs_radius, horizon)
    t_min = torch.where(obs_mask, t_ao, inf).amin(1)   # (L,)

    O = obs_pred.shape[1]
    t_oo = geo.collision_time_linear(
        o_start[:, :, None], o_end[:, :, None],
        o_start[:, None, :], o_end[:, None, :],
        obs_radius[:, :, None] + obs_radius[:, None, :], horizon)
    idx = torch.arange(O, device=init.device)
    pair_mask = (obs_mask[:, :, None] & obs_mask[:, None, :] &
                 (idx[:, None] < idx[None, :]))
    t_min = torch.minimum(t_min,
                          torch.where(pair_mask, t_oo, inf).amin((1, 2)))

    if esdf is not None:
        n_samp = max(int(np.ceil(horizon / search_step)) + 1, 2)
        taus = torch.linspace(0.0, 1.0, n_samp, dtype=init.dtype,
                              device=init.device)
        pts = (a_start[:, None, :] +
               (a_end - a_start)[:, None, :] * taus[:, None])  # (L, S, 3)
        hit = esdf.at_points(pts) < agent_radius[:, None]
        t_samp = torch.where(hit, taus * horizon, inf)
        t_min = torch.minimum(t_min, t_samp.amin(1))

    alpha = torch.clamp((t_min - eps) / horizon, 0.0, 1.0)
    return torch.where(torch.isfinite(t_min), alpha, 1.0)


def contract_trajectories(traj, alpha):
    """Control points scaled toward the trajectory start by alpha
    (traj_planner.cpp:1323-1328): c <- c0 + alpha (c - c0).
    traj (..., M, n+1, 3); alpha broadcastable to the batch dims."""
    c0 = traj[..., 0:1, 0:1, :]
    return c0 + alpha[..., None, None, None] * (traj - c0)
