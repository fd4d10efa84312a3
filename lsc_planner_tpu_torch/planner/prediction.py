"""Obstacle prediction / initial trajectory (port of
lsc_planner_tpu/planner/prediction.py: the previous-solution shift, the
constant-velocity and constant-position trajectories, the slow-down of
the linear prediction modes, the uncertainty-inflated obstacle sizes and
the disturbance gates of experiment mode)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import bernstein as bz


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


_size_tables = {}


def _size_inflation(M, n, dt, uncertainty_horizon, dtype, device):
    """(M, n+1) inflation a unit of max_acc, made once a (shape, dtype,
    device): the constant-acceleration growth 0.5 a t^2 in Bernstein form
    (through B^-1) below the uncertainty horizon, saturated beyond
    (obstacleSizePredictionWithConstAcc, traj_planner.cpp:880-919)."""
    key = (M, n, dt, uncertainty_horizon, dtype, device)
    if key not in _size_tables:
        M_unc = int((uncertainty_horizon + 1e-9) / dt)
        B_inv = bz.bernstein_matrix_inv(n)
        rows = []
        for m in range(M):
            if m < M_unc:
                coef = np.zeros(n + 1)
                coef[0] = 0.5 * (m * dt) ** 2
                coef[1] = m * dt ** 2
                coef[2] = 0.5 * dt ** 2
                rows.append(coef @ B_inv)
            else:
                rows.append(np.full(n + 1, 0.5 * (M_unc * dt) ** 2))
        _size_tables[key] = torch.as_tensor(np.stack(rows), dtype=dtype,
                                            device=device)
    return _size_tables[key]


def obstacle_size_prediction(radius, max_acc, M: int, n: int, dt: float,
                             uncertainty_horizon: float,
                             size_prediction: bool = True):
    """Uncertainty-inflated obstacle radii per (segment, control point):
    radius, max_acc (...,) -> sizes (..., M, n+1); without size_prediction
    the radius itself."""
    if not size_prediction:
        return radius[..., None, None].expand(*radius.shape, M, n + 1)
    infl = _size_inflation(M, n, dt, uncertainty_horizon, radius.dtype,
                           radius.device)
    return radius[..., None, None] + max_acc[..., None, None] * infl


def prediction_check(pred, obs_pos, reset_threshold: float):
    """Disturbance gate (obstaclePredictionCheck, traj_planner.cpp:866-878):
    a prediction whose start is farther than the reset threshold from the
    observed position is frozen there and flagged for slack.
    pred (..., O, M, n+1, 3), obs_pos (..., O, 3) -> (pred',
    flags (..., O))."""
    start = pred[..., 0, 0, :]
    deviated = torch.linalg.vector_norm(start - obs_pos, dim=-1) > \
        reset_threshold
    frozen = obs_pos[..., None, None, :].expand(pred.shape)
    return torch.where(deviated[..., None, None, None], frozen, pred), \
        deviated


def initial_traj_check(init, pos, reset_threshold: float):
    """The same gate on the agent's own initial trajectory
    (initialTrajPlanningCheck, traj_planner.cpp:1047-1061): deviated agents
    restart from their position and re-seed their SFC.
    init (N, M, n+1, 3), pos (N, 3) -> (init', reset flags (N,))."""
    deviated = torch.linalg.vector_norm(init[:, 0, 0, :] - pos, dim=-1) > \
        reset_threshold
    frozen = pos[:, None, None, :].expand(init.shape)
    return torch.where(deviated[:, None, None, None], frozen, init), deviated


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
