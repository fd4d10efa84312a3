"""LSC collision constraints (port of pair_downwash, lsc_planes and
concat_planes from lsc_planner_tpu/planner/constraints.py).

One batched tensor program over every (agent, obstacle, segment) triple
(generateLSC, traj_planner.cpp:1310-1407).  Contractions over the 3-D
coordinate are written as products and sums, never as matmuls, so world
coordinates stay exact f32 on every device.
"""
from __future__ import annotations

import torch

from ..ops import hull as hull_ops
from .optimizer import PlaneConstraints


def pair_downwash(agent_radius, agent_downwash, obs_radius, obs_downwash,
                  obs_is_agent):
    """Combined downwash (traj_planner.cpp:1336-1345): agents mix both
    coefficients; non-agents use 1.0 for the ego agent."""
    dw_agent = ((agent_downwash * agent_radius + obs_downwash * obs_radius)
                / (agent_radius + obs_radius))
    dw_other = ((agent_radius + obs_downwash * obs_radius)
                / (agent_radius + obs_radius))
    return torch.where(obs_is_agent, dw_agent, dw_other)


def lsc_planes(init_traj, obs_pred, agent_radius, agent_downwash,
               obs_radius, obs_downwash, obs_is_agent, obs_mask,
               slack_flags=None, obs_pred_sizes=None,
               guard_margin: float = 0.0) -> PlaneConstraints:
    """Linear Safe Corridor planes for all (agent, obstacle, segment).

    init_traj: (N, M, n+1, 3); obs_pred: (N, O, M, n+1, 3);
    agent_radius/downwash: (N,); obs_radius/downwash, obs_is_agent,
    obs_mask: (N, O).  guard_margin inflates each row's margin by
    min(guard, s0/2), s0 its slack at the initial trajectory, which keeps
    the shifted previous solution feasible (see the JAX package)."""
    if slack_flags is not None or obs_pred_sizes is not None:
        raise NotImplementedError("slack-marked LSC rows (disturbance "
                                  "path) are not ported (ROADMAP queue 1, "
                                  "item 12)")
    N, O, M = obs_pred.shape[:3]

    dw = pair_downwash(agent_radius[:, None], agent_downwash[:, None],
                       obs_radius, obs_downwash, obs_is_agent)   # (N, O)
    scale = torch.stack([torch.ones_like(dw), torch.ones_like(dw),
                         1.0 / dw], dim=-1)                       # (N, O, 3)
    init_t = init_traj[:, None] * scale[:, :, None, None, :]
    obs_t = obs_pred * scale[:, :, None, None, :]

    rel = init_t - obs_t                                  # (N, O, M, n1, 3)
    normal_t, _ = hull_ops.hull_normal(rel)               # (N, O, M, 3)

    collision_dist = agent_radius[:, None] + obs_radius   # (N, O)
    e = (rel * normal_t[..., None, :]).sum(-1)            # rel_i . n_t
    d = 0.5 * (collision_dist[..., None, None] + e)
    if guard_margin > 0.0:
        s0 = 0.5 * (e - collision_dist[..., None, None])
        d = d + torch.clamp(0.5 * s0, 0.0, guard_margin)

    # untransform the normal (z divided by downwash, traj_planner.cpp:1403)
    normal = torch.cat([normal_t[..., :2],
                        normal_t[..., 2:3] / dw[..., None, None]], dim=-1)
    rhs = d + (obs_pred * normal[..., None, :]).sum(-1)
    mask = obs_mask[..., None].expand(N, O, M)
    return PlaneConstraints(normal=normal, rhs=rhs, mask=mask)


def concat_planes(*plane_sets, n_ctrl: int) -> PlaneConstraints:
    """Concatenate plane sets along the constraint axis, broadcasting rhs to
    (N, C, M, n_ctrl)."""
    normals, rhss, masks = [], [], []
    for ps in plane_sets:
        if ps is None:
            continue
        N, C, M = ps.normal.shape[:3]
        rhs = ps.rhs.expand(N, C, M, n_ctrl) \
            if ps.rhs.shape[-1] != n_ctrl else ps.rhs
        normals.append(ps.normal)
        rhss.append(rhs)
        masks.append(ps.mask)
    return PlaneConstraints(normal=torch.cat(normals, dim=1),
                            rhs=torch.cat(rhss, dim=1),
                            mask=torch.cat(masks, dim=1))
