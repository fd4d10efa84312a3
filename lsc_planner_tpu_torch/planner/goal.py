"""Goal planning stage (port of lsc_planner_tpu/planner/goal.py): the
STATIC, RIGHT_HAND, PRIOR_BASED and ORCA modes; with a static world (esdf)
the PRIOR_BASED sub-goal comes from the grid planner, ops/grid_search.py.
The ORCA goal mode advances along the ORCA planner's velocities, so it
needs the ORCA planner mode."""
from __future__ import annotations

import dataclasses

import torch

from ..config import GoalMode, Param, PlannerMode, SP_INFINITY
from ..missions import Mission
from ..ops.geometry import closest_point_on_segment


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
        p = self.param
        if p.goal_mode == GoalMode.ORCA and \
                p.planner_mode != PlannerMode.ORCA:
            raise ValueError(self._orca_combination())

    def _orca_combination(self):
        # the JAX package passes no ORCA velocities to its goal rule in any
        # other planner mode and fails inside the cycle
        return (f"goal mode {GoalMode.ORCA.value} advances along the ORCA "
                "planner's velocities; planner mode "
                f"{self.param.planner_mode.value} computes none")

    def plan(self, pos, vel, init_traj, desired_goal, seq, radius,
             downwash, prev_traj=None, obs_pos=None, obs_goal=None,
             obs_prev_traj=None, self_mask=None, obs_radius=None,
             obs_downwash=None, orca_vel=None):
        """Current goals (L, 3) and the rescue path floor (L, 3) for a block
        of agents against the global obstacle view (defaults: the block
        itself); orca_vel (L, 3), the ORCA velocities, for the ORCA goal
        mode."""
        if obs_pos is None:
            obs_pos, obs_goal = pos, desired_goal
            obs_prev_traj = prev_traj if prev_traj is not None \
                else init_traj
            obs_radius, obs_downwash = radius, downwash
            self_mask = torch.eye(pos.shape[0], dtype=torch.bool,
                                  device=pos.device)
        if self.param.goal_mode == GoalMode.STATIC:
            return desired_goal, pos
        if self.param.goal_mode == GoalMode.RIGHT_HAND:
            return self._right_hand(pos, vel, desired_goal, seq), pos
        if self.param.goal_mode == GoalMode.ORCA:
            if orca_vel is None:
                raise ValueError(self._orca_combination())
            return self._orca_goal(pos, desired_goal, orca_vel), pos
        return self._prior_based(pos, init_traj, desired_goal, radius,
                                 downwash, obs_pos, obs_goal, obs_prev_traj,
                                 self_mask, obs_radius, obs_downwash)

    def _orca_goal(self, pos, desired_goal, orca_vel):
        """goalPlanningWithORCA (traj_planner.cpp:515-526): advance along
        the ORCA velocity over the horizon; snap to the desired goal when it
        lies within 0.05 m of that segment."""
        p = self.param
        cand = pos + orca_vel * (p.M * p.dt)
        _, dist = closest_point_on_segment(desired_goal, pos, cand)
        return torch.where((dist < 0.05)[:, None], desired_goal, cand)

    def _right_hand(self, pos, vel, desired_goal, seq):
        """A deadlocked agent's goal moves to the right of its goal
        direction, (goal - pos) x z_hat (goalPlanningWithRightHandRule,
        traj_planner.cpp:528-538; deadlock test isDeadlock :1733-1748)."""
        p = self.param
        dist_to_goal = torch.linalg.vector_norm(pos - desired_goal, dim=-1)
        deadlock = ((seq > p.deadlock_seq_threshold) &
                    (torch.linalg.vector_norm(vel, dim=-1) <
                     p.deadlock_velocity_threshold) &
                    (dist_to_goal > p.goal_threshold))
        z_axis = torch.zeros_like(pos)
        z_axis[:, 2].fill_(1.0)
        right = torch.linalg.cross(desired_goal - pos, z_axis, dim=-1)
        return torch.where(deadlock[:, None], pos + right, desired_goal)

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
