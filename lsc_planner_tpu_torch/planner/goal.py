"""Goal planning stage (port of lsc_planner_tpu/planner/goal.py for the
STATIC and PRIOR_BASED modes in a world without a grid)."""
from __future__ import annotations

import dataclasses

import torch

from lsc_planner_tpu.config import GoalMode, Param, SP_INFINITY
from lsc_planner_tpu.missions import Mission


def _normalize(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


@dataclasses.dataclass
class GoalPlanner:
    mission: Mission
    param: Param
    esdf: object = None

    def __post_init__(self):
        if self.esdf is not None:
            raise NotImplementedError("grid goal planning in octomap worlds "
                                      "is not ported (ROADMAP queue 1, "
                                      "item 11)")
        if self.param.goal_mode not in (GoalMode.STATIC,
                                        GoalMode.PRIOR_BASED):
            raise NotImplementedError(
                f"goal mode {self.param.goal_mode.value} is not ported "
                "(ROADMAP queue 1, items 12-13)")

    def plan(self, pos, vel, init_traj, desired_goal, seq, radius,
             downwash, prev_traj=None, obs_pos=None, obs_goal=None,
             obs_prev_traj=None, self_mask=None, obs_radius=None,
             obs_downwash=None):
        """Current goals (L, 3) and the rescue path floor (L, 3) for a block
        of agents against the global obstacle view (defaults: the block
        itself)."""
        if obs_pos is None:
            obs_pos, obs_goal = pos, desired_goal
            obs_prev_traj = prev_traj if prev_traj is not None \
                else init_traj
            self_mask = torch.eye(pos.shape[0], dtype=torch.bool,
                                  device=pos.device)
        if self.param.goal_mode == GoalMode.STATIC:
            return desired_goal, pos
        return self._prior_based(pos, init_traj, desired_goal, obs_pos,
                                 obs_goal, obs_prev_traj, self_mask)

    def _prior_based(self, pos, init_traj, desired_goal, obs_pos, obs_goal,
                     obs_prev_traj, self_mask):
        """goalPlanningWithPriority (traj_planner.cpp:540-608); with no
        grid the LOS-free goal is the desired goal (goal.py:152-157)."""
        p = self.param
        dist_to_goal = torch.linalg.vector_norm(pos - desired_goal, dim=-1)
        obs_dist_to_goal = torch.linalg.vector_norm(
            obs_pos - obs_goal, dim=-1)[None, :]                 # (1, N)
        dist_to_obs = torch.linalg.vector_norm(
            obs_pos[None, :] - pos[:, None], dim=-1)             # (L, N)

        near_own_goal = dist_to_goal < p.goal_threshold
        obs_near_goal = obs_dist_to_goal < p.goal_threshold

        # "same direction" skip from the obstacle's previous solution
        obs_end = obs_prev_traj[:, -1, -1, :]
        obs_first_end = obs_prev_traj[:, 0, -1, :]
        dirn = ((obs_end - obs_first_end)[None, :, :] *
                (obs_first_end[None, :, :] - pos[:, None, :])).sum(-1)
        same_dir = (~near_own_goal[:, None]) & (dirn > 0)

        higher = ((~self_mask) & (~obs_near_goal) & (~same_dir) &
                  (near_own_goal[:, None] |
                   (obs_dist_to_goal < dist_to_goal[:, None])))

        d_hp = torch.where(higher, dist_to_obs,
                           torch.full_like(dist_to_obs, SP_INFINITY))
        min_dist, closest = torch.min(d_hp, dim=1)

        # back-away rule (traj_planner.cpp:579-587)
        dist_keep = p.priority_dist_threshold + 0.1
        away = pos - _normalize(obs_pos[closest] - pos) * dist_keep
        too_close = min_dist < p.priority_dist_threshold

        init_end = init_traj[:, -1, -1, :]
        los_goal = desired_goal
        delta = los_goal - init_end
        dist = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
        clamped = torch.where(dist > p.goal_radius,
                              init_end + _normalize(delta) * p.goal_radius,
                              los_goal)
        return torch.where(too_close[:, None], away, clamped), pos
