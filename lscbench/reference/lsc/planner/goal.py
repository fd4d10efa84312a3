"""Goal planning stage (port of lsc_planner_tpu/planner/goal.py), the
PRIOR_BASED mode alone; with a static world (esdf) its sub-goal comes
from the grid planner, ops/grid_search.py."""
from __future__ import annotations

import dataclasses

import torch

from ..config import Param, SP_INFINITY
from ..missions import Mission


def _normalize(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


@dataclasses.dataclass
class GoalPlanner:
    mission: Mission
    param: Param
    esdf: object = None           # world.esdf.ESDF of a static world
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.grid_planner = None
        if self.esdf is not None:
            from ..ops.grid_search import GridPlanner
            self.grid_planner = GridPlanner(self.mission, self.param,
                                            self.esdf, dtype=self.dtype)

    def plan(self, pos, init_traj, desired_goal, radius, downwash, obs_pos,
             obs_goal, obs_prev_traj, self_mask, obs_radius, obs_downwash):
        """Current goals (L, 3) and the rescue path floor (L, 3) for a block
        of agents against the global obstacle view."""
        return self._prior_based(pos, init_traj, desired_goal, radius,
                                 downwash, obs_pos, obs_goal, obs_prev_traj,
                                 self_mask, obs_radius, obs_downwash)

    def _prior_based(self, pos, init_traj, desired_goal, radius, downwash,
                     obs_pos, obs_goal, obs_prev_traj, self_mask,
                     obs_radius, obs_downwash):
        """goalPlanningWithPriority (traj_planner.cpp:540-608): the grid
        planner's LOS-free goal in a static world; with no grid it is the
        desired goal and the path floor is the agent itself
        (goal.py:148-157)."""
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
        if self.grid_planner is not None:
            los_goal, path_floor = self.grid_planner.plan_goals(
                pos, init_end, desired_goal, radius, downwash, obs_pos,
                obs_radius, obs_downwash, higher)
        else:
            los_goal, path_floor = desired_goal, pos
        delta = los_goal - init_end
        dist = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
        clamped = torch.where(dist > p.goal_radius,
                              init_end + _normalize(delta) * p.goal_radius,
                              los_goal)
        return torch.where(too_close[:, None], away, clamped), path_floor
