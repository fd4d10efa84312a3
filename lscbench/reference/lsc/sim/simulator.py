"""One synchronous planning cycle of the LSC planner, plain PyTorch: a
frozen copy of the port's ``sim/simulator.py`` (propagation, stall and
rescue bookkeeping, prediction, the goal rule, K-NN pruning, LSC planes,
the SFC corridor in a static world, the trajectory QP, the QPFAILED
fallback and the sampled safety audit), cut to the modes the benchmark's
configurations run (``config.Param.validated`` refuses the others): LSC
with previous-solution prediction, PRIOR_BASED goals with deadlock
rescue, static boxes only; no CUDA graphs, no host loop.  Every operation is a plain PyTorch one; no kernel of the port
is reachable from here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Param
from ..missions import Mission
from ..device import resolve_device
from ..ops.geometry import knn_select
from ..planner import constraints as cons
from ..planner import goal as goal_mod
from ..planner import prediction as pred
from ..planner.optimizer import TrajOptimizer
from ..world.corridor import CorridorBuilder, update_sfc
from ..world.esdf import ESDF
from . import audit


class SwarmState(NamedTuple):
    """Swarm state carried across planning cycles (fields as in the JAX
    package; sfc is carried unchanged by the empty-world cycle;
    slack_flags, set by inject_positions, are one-shot: the next cycle
    reads and clears them)."""
    traj: torch.Tensor          # (N, M, n+1, 3) current solutions
    pos: torch.Tensor           # (N, 3)
    vel: torch.Tensor           # (N, 3)
    acc: torch.Tensor           # (N, 3)
    current_goal: torch.Tensor  # (N, 3)
    seq: torch.Tensor           # () int32 planner sequence number
    qp_cost: torch.Tensor       # (N,)
    primal_res: torch.Tensor    # (N,) constraint violation of last QP
    safety_agent_min: torch.Tensor  # () running min inter-agent ratio
    distance: torch.Tensor      # () running total flight distance
    sfc: torch.Tensor           # (N, M, 6)
    sfc_initialized: torch.Tensor   # (N,) bool
    start: torch.Tensor         # (N, 3) mission start (patrol swaps)
    desired_goal: torch.Tensor  # (N, 3)
    safety_obs_min: torch.Tensor    # () running min agent-obstacle ratio
    stall_count: torch.Tensor   # (N,) int32 consecutive low-velocity cycles
    rescue_goal: torch.Tensor   # (N, 3) latched deadlock-escape waypoint
    rescue_active: torch.Tensor     # (N,) bool
    rescue_phase: torch.Tensor  # (N,) int32 escalation phase
    slack_flags: Optional[torch.Tensor] = None   # (N,) bool
    path_floor: Optional[torch.Tensor] = None    # (N, 3)
    best_goal_dist: Optional[torch.Tensor] = None    # (N,)


class CycleInfo(NamedTuple):
    safety_step_min: torch.Tensor
    qp_cost: torch.Tensor
    primal_res: torch.Tensor
    warm_res: Optional[torch.Tensor] = None
    warm_row: Optional[torch.Tensor] = None
    qp_failed: Optional[torch.Tensor] = None
    knn_overflow: Optional[torch.Tensor] = None
    qp_iters: Optional[torch.Tensor] = None


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _update_stall_count(prev_count, best_prev, prev_pos, pos, vel,
                        desired_goal, seq, p):
    """Stall counter with progress hysteresis (simulator.py:93-136).
    Returns (count, progress, progress_best, best)."""
    dist = _norm(pos - desired_goal)
    prev_dist = _norm(prev_pos - desired_goal)
    progress = (prev_dist - dist) > p.deadlock_progress_eps
    progress_best = (best_prev - dist) > p.deadlock_progress_eps
    best = torch.minimum(best_prev, dist)
    stalled = ((_norm(vel) < p.deadlock_velocity_threshold) &
               (dist > p.goal_threshold) & (seq > 0))
    reset = progress | (dist <= p.goal_threshold)
    count = torch.where(reset, 0,
                        torch.where(stalled, prev_count + 1,
                                    torch.clamp(prev_count - 1, min=0)))
    return count.to(prev_count.dtype), progress, progress_best, best


_rotation_cache = {}


def _rotations(dtype, device):
    """(cos, sin) of the three candidate rotations k pi / 2, k = 1..3, as
    0-d tensors made once a (dtype, device): no cycle copies them from the
    host."""
    key = (dtype, device)
    if key not in _rotation_cache:
        cs = []
        for k in range(1, 4):
            theta = torch.tensor((math.pi / 2.0) * k, dtype=dtype,
                                 device=device)
            cs.append((torch.cos(theta), torch.sin(theta)))
        _rotation_cache[key] = cs
    return _rotation_cache[key]


def _update_rescue(state, pos, desired_goal, stall_count, progress, p,
                   esdf=None, radius=None, world_min=None, world_max=None,
                   progress_best=None):
    """Latched deadlock-escape waypoints (simulator.py:139-305).  With a
    static world (esdf) each candidate's straight ray from the agent is
    checked against the ESDF, and the first admissible one from the
    escalation phase on is taken.
    Returns (rescue_goal, rescue_active, rescue_phase, stall_count)."""
    path_floor = state.path_floor
    n_cand = 4 if path_floor is None else 5
    reached = (_norm(pos - state.rescue_goal) < p.goal_threshold) & \
        state.rescue_active
    if progress_best is None:
        progress_best = progress
    phase = torch.where(progress_best, 0, state.rescue_phase)
    active = state.rescue_active & ~progress & ~reached

    gdir = desired_goal - pos
    gnorm = _norm(gdir, keepdim=True)
    reach = torch.clamp(gnorm, max=1.0)

    over = stall_count > p.deadlock_seq_threshold
    expire = active & (stall_count > p.rescue_expire_cycles)
    active = active & ~expire
    phase_start = phase % n_cand
    far = gnorm[..., 0] > 0.5 * p.goal_radius
    engage = (over | expire) & ~active & far
    stall_count = torch.where(engage, 0, stall_count)

    dirs = []
    for c, s in _rotations(pos.dtype, pos.device):
        rot = torch.stack([c * gdir[..., 0] + s * gdir[..., 1],
                           -s * gdir[..., 0] + c * gdir[..., 1],
                           gdir[..., 2]], dim=-1)
        dirs.append(rot / torch.clamp(_norm(rot, keepdim=True), min=1e-12))
    up = torch.zeros_like(pos)
    up[..., 2].fill_(1.0)
    dirs.append(up)
    cands = torch.stack([pos + d * reach for d in dirs], dim=-2)  # (N,4,3)
    floor_ok = None
    if path_floor is not None:
        cands = torch.cat([path_floor[..., None, :], cands], dim=-2)
        floor_vec = path_floor - pos
        floor_norm = _norm(floor_vec)
        sub_vec = state.current_goal - pos
        denom = torch.clamp(floor_norm * _norm(sub_vec), min=1e-9)
        cosang = (floor_vec * sub_vec).sum(-1) / denom
        floor_ok = (floor_norm > 0.3) & (cosang < 0.8)
    if world_min is not None:
        r_c = radius[..., None, None]
        cands = torch.clamp(cands, world_min + r_c, world_max - r_c)

    if esdf is not None and radius is not None:
        # the threshold is clamped just under the agent's own clearance, so
        # a sub-margin pocket still rotates through candidates
        t = torch.linspace(0.0, 1.0, 9, dtype=pos.dtype, device=pos.device)
        ray = pos[..., None, None, :] + \
            (cands - pos[..., None, :])[..., None, :] * \
            t[None, None, :, None]                         # (N, C, S, 3)
        min_clear = esdf.at_points(ray).amin(-1)           # (N, C)
        own_clear = esdf.at_points(pos)[..., None]         # (N, 1)
        thr = torch.minimum(radius[..., None] + 0.5 * p.world_resolution,
                            own_clear - 1e-3)
        valid = min_clear > thr
    else:
        valid = torch.ones(cands.shape[:-1], dtype=torch.bool,
                           device=pos.device)
    if floor_ok is not None:
        valid[..., 0] = valid[..., 0] & floor_ok

    # first valid candidate at or after the escalation phase (cyclic)
    order = (torch.arange(n_cand, device=pos.device)[None, :] -
             phase_start[..., None]) % n_cand
    score = torch.where(valid, order, n_cand + order)
    pick = torch.argmin(score, dim=-1)
    waypoint = torch.gather(
        cands, -2, pick[..., None, None].expand(*pick.shape, 1, 3))[..., 0, :]
    rescue_goal = torch.where(engage[..., None], waypoint, state.rescue_goal)
    phase_new = torch.where(engage, (pick + 1).to(phase.dtype), phase)
    return rescue_goal, active | engage, phase_new, stall_count


def _stack_cycles(cycle, state, k):
    """k calls of cycle from state, their outputs stacked as the JAX
    package's scan body gives them: (state_k, (CycleInfo stacked (k, ...),
    max_goal_dist (k,), cum_distance (k,)))."""
    infos, goal_dist, cum_dist = [], [], []
    for _ in range(k):
        state, info = cycle(state)
        infos.append(info)
        goal_dist.append(_norm(state.pos - state.desired_goal).max())
        cum_dist.append(state.distance)
    stacked = CycleInfo(*[None if f[0] is None else torch.stack(f)
                          for f in zip(*infos)])
    return state, (stacked, torch.stack(goal_dist), torch.stack(cum_dist))


@dataclasses.dataclass
class SyncSimulator:
    """Batched synchronous replanning loop for one mission, with every
    tensor on `device`."""
    mission: Mission
    param: Param
    device: object = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.param = self.param.validated()
        p = self.param
        self.device = resolve_device(self.device)
        self.N = self.mission.qn
        self.M, self.n = p.M, p.n
        if any(o.kind != "static" for o in self.mission.obstacles):
            raise ValueError("the reference runs no dynamic obstacles")
        static_specs = self.mission.obstacles
        self.optimizer = TrajOptimizer(p)

        arrs = self.mission.agent_arrays()

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                   device=self.device)
        self.start = t(arrs["start"])
        self.desired_goal = t(arrs["goal"])
        self.radius = t(arrs["radius"])
        self.downwash = t(arrs["downwash"])
        self.nominal_velocity = t(arrs["nominal_velocity"])
        self.max_vel = t(arrs["max_vel"])
        self.max_acc = t(arrs["max_acc"])
        self.world_min = t(self.mission.world_min)
        self.world_max = t(self.mission.world_max)
        self.self_mask = torch.eye(self.N, dtype=torch.bool,
                                   device=self.device)
        # K-NN interaction-ball radius (simulator.py:343-350): a feasible
        # trajectory stays within vmax * horizon of its start, so pairs
        # farther apart than this cannot interact within one horizon
        self._knn_cutoff = float(2.0 * np.max(arrs["max_vel"]) * p.M * p.dt +
                                 2.0 * np.max(arrs["radius"]))

        # static boxes are world geometry (simulator.py:351-380): folded
        # into the ESDF, so the corridor, the grid planner and the rescue
        # ray checks see them, and audited exactly
        self.esdf = None
        if static_specs:
            boxes = np.stack([
                np.concatenate([np.asarray(o.pose, float) -
                                np.asarray(o.dimensions, float),
                                np.asarray(o.pose, float) +
                                np.asarray(o.dimensions, float)])
                for o in static_specs])
            self.static_boxes = t(boxes)
            self.esdf = ESDF.from_boxes(
                boxes, self.mission.world_min, self.mission.world_max,
                resolution=p.world_resolution, dtype=self.dtype,
                device=self.device)
        else:
            self.static_boxes = t(np.zeros((0, 6)))

        self.corridor = None
        if self.esdf is not None:
            # mission/world compatibility gate: a start or goal inside the
            # static world makes the SFC seed infeasible (the reference
            # throws from expandBoxFromPoint, corridor_constructor.hpp:35-38)
            s_clear = self.esdf.at_points(self.start).cpu().numpy()
            g_clear = self.esdf.at_points(self.desired_goal).cpu().numpy()
            r = np.asarray(arrs["radius"])
            bad = [(qi, float(s_clear[qi]), float(g_clear[qi]))
                   for qi in range(self.N)
                   if s_clear[qi] < r[qi] or g_clear[qi] < r[qi]]
            if bad:
                raise ValueError(
                    "mission incompatible with world: start/goal inside or "
                    f"too close to static obstacles for agents {bad} "
                    "(agent, start clearance, goal clearance)")
            self.corridor = CorridorBuilder(
                self.esdf, self.mission.world_min, self.mission.world_max,
                agent_radius=float(self.mission.agents[0].radius),
                dtype=self.dtype)
        self.goal_planner = goal_mod.GoalPlanner(self.mission, p, self.esdf,
                                                 dtype=self.dtype)

    # ------------------------------------------------------------------
    def initial_state(self) -> SwarmState:
        N, M, n = self.N, self.M, self.n
        dt, dev = self.dtype, self.device
        zeros = torch.zeros((N, 3), dtype=dt, device=dev)
        inf = torch.tensor(float("inf"), dtype=dt, device=dev)
        return SwarmState(
            traj=self.start[:, None, None, :].expand(N, M, n + 1, 3).clone(),
            pos=self.start, vel=zeros, acc=zeros,
            current_goal=self.desired_goal,
            seq=torch.zeros((), dtype=torch.int32, device=dev),
            qp_cost=torch.zeros((N,), dtype=dt, device=dev),
            primal_res=torch.zeros((N,), dtype=dt, device=dev),
            safety_agent_min=inf,
            distance=torch.zeros((), dtype=dt, device=dev),
            sfc=torch.zeros((N, M, 6), dtype=dt, device=dev),
            sfc_initialized=torch.zeros((N,), dtype=torch.bool, device=dev),
            start=self.start, desired_goal=self.desired_goal,
            safety_obs_min=inf,
            stall_count=torch.zeros((N,), dtype=torch.int32, device=dev),
            rescue_goal=zeros,
            rescue_active=torch.zeros((N,), dtype=torch.bool, device=dev),
            rescue_phase=torch.zeros((N,), dtype=torch.int32, device=dev),
            slack_flags=torch.zeros((N,), dtype=torch.bool, device=dev),
            path_floor=self.start,
            best_goal_dist=torch.full((N,), float("inf"), dtype=dt,
                                      device=dev),
        )

    # ------------------------------------------------------------------
    def propagate(self, state: SwarmState):
        """Ideal rollout of the previous solutions by one time step
        (multi_sync_simulator.cpp:190-246); LSC's time step is dt, so it
        lands on the segment-1 boundary, given by the first control
        points."""
        p = self.param
        n = self.n
        seg = state.traj[:, 1]
        rpos = seg[:, 0]
        rvel = (seg[:, 1] - seg[:, 0]) * (n / p.dt)
        racc = (seg[:, 2] - 2 * seg[:, 1] + seg[:, 0]) * \
            (n * (n - 1) / p.dt ** 2)
        is_first = state.seq == 0
        return (torch.where(is_first, state.pos, rpos),
                torch.where(is_first, state.vel, rvel),
                torch.where(is_first, state.acc, racc))

    def predict_and_init(self, traj, pos, vel, seq):
        """Obstacle prediction and initial trajectory, one tensor under the
        previous-solution modes (traj_planner.cpp:848-858): the previous
        solution shifted one segment, constant velocity in the first
        cycle.  Returns (init, prediction)."""
        shifted = pred.shift_previous_solution(traj)
        const_vel = pred.constant_velocity_traj(pos, vel, self.M, self.n,
                                                self.param.dt)
        prediction = torch.where(seq >= 1, shifted, const_vel)
        return prediction, prediction

    def plan_block(self, pos, vel, acc, init, prediction, prev_traj,
                   desired_goal, sfc_prev, sfc_initialize, sfc_seed,
                   rescue_goal, rescue_active):
        """Plan every agent: goals, K-NN pruning, LSC planes, the SFC
        corridor in a static world, QP.  Returns (QPResult, current_goal,
        sfc, knn_overflow, path_floor); knn_overflow (N,) flags agents
        whose K-th nearest neighbour is still inside the interaction ball
        (None without pruning); sfc is sfc_prev without a static world."""
        p = self.param
        N = O = pos.shape[0]
        M, n = self.M, self.n

        current_goal, path_floor = self.goal_planner.plan(
            pos, init, desired_goal, self.radius, self.downwash,
            obs_pos=pos, obs_goal=desired_goal, obs_prev_traj=prev_traj,
            self_mask=self.self_mask, obs_radius=self.radius,
            obs_downwash=self.downwash)
        current_goal = torch.where(rescue_active[:, None], rescue_goal,
                                   current_goal)

        K = p.max_neighbors
        knn_overflow = None
        if 0 < K < O:
            # K-NN pruning of the LSC pairs (simulator.py:611-662); an
            # index gather replaces the TPU's one-hot selection matmul
            sel_d2, nbr = knn_select(pos, pos, self.self_mask, K)
            r2 = self._knn_cutoff * self._knn_cutoff
            knn_overflow = sel_d2[:, -1] < r2
            obs_pred = prediction[nbr]                      # (N, K, M, n1, 3)
            obs_radius = self.radius[nbr]
            obs_downwash = self.downwash[nbr]
            obs_mask = sel_d2 <= r2
            O = K
        else:
            obs_pred = prediction[None].expand(N, O, M, n + 1, 3)
            obs_radius = self.radius[None, :].expand(N, O)
            obs_downwash = self.downwash[None, :].expand(N, O)
            obs_mask = ~self.self_mask
        obs_is_agent = torch.ones((N, O), dtype=torch.bool,
                                  device=pos.device)
        planes = cons.lsc_planes(
            init, obs_pred, self.radius, self.downwash, obs_radius,
            obs_downwash, obs_is_agent, obs_mask,
            guard_margin=p.lsc_guard_margin)

        # SFC corridors against the static world (generateFeasibleSFC,
        # traj_planner.cpp:1451-1491), their faces after the LSC rows
        sfc = sfc_prev
        if self.corridor is not None:
            sfc, _ = update_sfc(sfc_prev, sfc_seed, current_goal,
                                self.corridor, sfc_initialize)
            sfc_pl = cons.sfc_planes(sfc, active=True, init_traj=init,
                                     guard_margin=p.lsc_guard_margin)
            planes = cons.concat_planes(planes, sfc_pl, n_ctrl=n + 1)
        else:
            planes = cons.concat_planes(planes, n_ctrl=n + 1)

        # warm start from the (feasible) shifted previous solution
        y_warm = self.optimizer.extract_y(init).to(self.dtype)
        res = self.optimizer.solve(
            pos, vel, acc, current_goal,
            nominal_velocity=self.nominal_velocity, max_vel=self.max_vel,
            max_acc=self.max_acc, planes=planes, world_min=self.world_min,
            world_max=self.world_max, y_warm=y_warm, dtype=self.dtype)
        return res, current_goal, sfc, knn_overflow, path_floor

    # ------------------------------------------------------------------
    def cycle(self, state: SwarmState):
        """One synchronous planning cycle for all agents.  Returns
        (new_state, CycleInfo)."""
        p = self.param
        pos, vel, acc = self.propagate(state)
        start, desired_goal = state.start, state.desired_goal

        stall_count, progress, progress_best, best_goal_dist = \
            _update_stall_count(state.stall_count, state.best_goal_dist,
                                state.pos, pos, vel, desired_goal,
                                state.seq, p)
        rescue_goal, rescue_active, rescue_phase, stall_count = \
            _update_rescue(state, pos, desired_goal, stall_count, progress,
                           p, esdf=self.esdf, radius=self.radius,
                           world_min=self.world_min,
                           world_max=self.world_max,
                           progress_best=progress_best)

        init, prediction = self.predict_and_init(state.traj, pos, vel,
                                                 state.seq)
        # SFC seed: the previous solution's endpoint, or the current
        # position on (re-)initialization (traj_planner.cpp:1454-1473)
        sfc_initialize = ~state.sfc_initialized
        sfc_seed = torch.where(sfc_initialize[:, None], pos,
                               state.traj[:, -1, -1, :])
        res, current_goal, sfc, knn_overflow, path_floor = self.plan_block(
            pos, vel, acc, init, prediction, state.traj, desired_goal,
            sfc_prev=state.sfc, sfc_initialize=sfc_initialize,
            sfc_seed=sfc_seed, rescue_goal=rescue_goal,
            rescue_active=rescue_active)

        # QPFAILED report + feasible fallback (simulator.py:890-898): a
        # failing agent keeps its shifted previous solution
        qp_failed = res.primal_res > p.qp_failure_threshold
        traj = torch.where(qp_failed[:, None, None, None], init, res.traj)

        safety_step = audit.step_safety_ratio(
            traj, self.radius, self.downwash, p.dt,
            p.multisim_record_time_step, p.multisim_time_step)
        step_dist = audit.step_distance(
            traj, p.dt, p.multisim_record_time_step, p.multisim_time_step)
        safety_obs = state.safety_obs_min
        if self.static_boxes.shape[0]:
            safety_obs = torch.minimum(safety_obs,
                                       audit.static_box_safety_ratio(
                                           pos, self.static_boxes,
                                           self.radius))

        new_state = SwarmState(
            traj=traj, pos=pos, vel=vel, acc=acc,
            current_goal=current_goal, seq=state.seq + 1,
            qp_cost=res.cost, primal_res=res.primal_res,
            safety_agent_min=torch.minimum(state.safety_agent_min,
                                           safety_step),
            distance=state.distance + step_dist,
            sfc=sfc,
            sfc_initialized=torch.ones_like(state.sfc_initialized),
            start=start, desired_goal=desired_goal,
            safety_obs_min=safety_obs,
            stall_count=stall_count, rescue_goal=rescue_goal,
            rescue_active=rescue_active, rescue_phase=rescue_phase,
            slack_flags=(torch.zeros_like(state.slack_flags)
                         if state.slack_flags is not None else None),
            path_floor=path_floor, best_goal_dist=best_goal_dist)
        info = CycleInfo(
            safety_step_min=safety_step, qp_cost=res.cost,
            primal_res=res.primal_res,
            warm_res=(res.warm_res if res.warm_res is not None
                      else torch.zeros_like(res.cost)),
            warm_row=(res.warm_row if res.warm_row is not None
                      else torch.zeros_like(res.cost, dtype=torch.int32)),
            qp_failed=qp_failed, knn_overflow=knn_overflow,
            qp_iters=res.iters)
        return new_state, info
