"""Obstacle prediction / initial trajectory (port of the previous-solution
and constant-velocity parts of lsc_planner_tpu/planner/prediction.py)."""
from __future__ import annotations

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
