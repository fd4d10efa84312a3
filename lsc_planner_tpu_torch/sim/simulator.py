"""Synchronous multi-agent replanning simulator (port of the LSC main path
of lsc_planner_tpu/sim/simulator.py).

One cycle for the whole swarm: propagate the previous solutions one time
step, stall/rescue bookkeeping, previous-solution prediction, the priority
goal rule, LSC planes, the batched trajectory QP, the QPFAILED fallback and
the sampled safety audit.  The tables live as tensors on an explicit
device; the cycle never syncs with the host (the QP's factored path syncs
only for its early exit), and ``run`` reads one small stats tensor back
per cycle.

With ``max_neighbors = K`` (0 < K < N) each agent keeps LSC rows only for
its K nearest neighbours, and the cycle reports the density-overflow audit
of that pruning in ``CycleInfo.knn_overflow``.

Off the ported slice (octomap worlds, static or dynamic obstacles, planner
modes other than LSC, experiment-mode pose injection, fused multi-cycle
dispatch) the constructor or the call raises NotImplementedError naming
its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from lsc_planner_tpu.config import Param, PlannerMode, PredictionMode
from lsc_planner_tpu.missions import Mission
from ..device import resolve_device, synchronize
from ..ops import bernstein as bz
from ..planner import constraints as cons
from ..planner import goal as goal_mod
from ..planner import prediction as pred
from ..planner.optimizer import TrajOptimizer
from . import audit


class SwarmState(NamedTuple):
    """Swarm state carried across planning cycles (fields as in the JAX
    package; sfc/sfc_initialized/slack_flags are carried unchanged by the
    empty-world LSC cycle)."""
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


def _update_rescue(state, pos, desired_goal, stall_count, progress, p,
                   radius=None, world_min=None, world_max=None,
                   progress_best=None):
    """Latched deadlock-escape waypoints, empty-world branch of
    simulator.py:139-305 (no ESDF ray validation).
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
    for k in range(1, 4):                                   # rotations
        theta = torch.tensor((math.pi / 2.0) * k, dtype=pos.dtype,
                             device=pos.device)
        c, s = torch.cos(theta), torch.sin(theta)
        rot = torch.stack([c * gdir[..., 0] + s * gdir[..., 1],
                           -s * gdir[..., 0] + c * gdir[..., 1],
                           gdir[..., 2]], dim=-1)
        dirs.append(rot / torch.clamp(_norm(rot, keepdim=True), min=1e-12))
    up = torch.zeros_like(pos)
    up[..., 2] = 1.0
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

    valid = torch.ones(cands.shape[:-1], dtype=torch.bool,
                       device=pos.device)
    if floor_ok is not None:
        valid[..., 0] = floor_ok

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


def knn_select(pos, obs_pos, self_mask, K: int):
    """The K nearest obstacles of each agent: (squared distances ascending
    (L, K), indices (L, K)).  The squares are summed over the axes in the
    JAX order, and a stable sort breaks ties by the lower index as
    ``lax.top_k`` does (a circle puts neighbours i - k and i + k at equal
    distances, so the K-th pick depends on it)."""
    diff = obs_pos[None, :, :] - pos[:, None, :]
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
    d2 = torch.where(self_mask, float("inf"), d2)
    sel_d2, nbr = torch.sort(d2, dim=-1, stable=True)
    return sel_d2[:, :K], nbr[:, :K]


def _no_rescue(state):
    return state.rescue_goal, torch.zeros_like(state.rescue_active), \
        torch.zeros_like(state.rescue_phase)


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
        if p.planner_mode != PlannerMode.LSC:
            raise NotImplementedError(
                f"planner mode {p.planner_mode.value} is not ported "
                "(ROADMAP queue 1, items 12-13)")
        if p.world_use_octomap:
            raise NotImplementedError("octomap worlds are not ported "
                                      "(ROADMAP queue 1, item 10)")
        if any(o.kind == "static" for o in self.mission.obstacles):
            raise NotImplementedError("static obstacles are not ported "
                                      "(ROADMAP queue 1, item 10)")
        if self.mission.obstacles:
            raise NotImplementedError("dynamic obstacles are not ported "
                                      "(ROADMAP queue 1, item 12)")
        if p.multisim_experiment:
            raise NotImplementedError("experiment-mode pose injection and "
                                      "slack rows are not ported (ROADMAP "
                                      "queue 1, item 12)")
        self.optimizer = TrajOptimizer(p)
        self.goal_planner = goal_mod.GoalPlanner(self.mission, p)

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
        (multi_sync_simulator.cpp:190-246); with time_step == dt it lands
        on the segment-1 boundary, given by the first control points."""
        p = self.param
        n = self.n
        if abs(p.multisim_time_step - p.dt) < 1e-9 and self.M > 1:
            seg = state.traj[:, 1]
            rpos = seg[:, 0]
            rvel = (seg[:, 1] - seg[:, 0]) * (n / p.dt)
            racc = (seg[:, 2] - 2 * seg[:, 1] + seg[:, 0]) * \
                (n * (n - 1) / p.dt ** 2)
        else:
            rolled = bz.traj_state_batch(state.traj, p.multisim_time_step,
                                         p.dt)
            rpos, rvel, racc = rolled["pos"], rolled["vel"], rolled["acc"]
        is_first = state.seq == 0
        return (torch.where(is_first, state.pos, rpos),
                torch.where(is_first, state.vel, rvel),
                torch.where(is_first, state.acc, racc))

    def predict_and_init(self, traj, pos, vel, seq):
        """Previous-solution prediction, which in LSC mode is also every
        agent's initial trajectory (the first cycle uses constant
        velocity).  Returns (init, prediction)."""
        p = self.param
        if p.prediction_mode != PredictionMode.PREVIOUS_SOLUTION:
            raise NotImplementedError(
                f"prediction mode {p.prediction_mode.value} is not ported "
                "(ROADMAP queue 1, item 12)")
        shifted = pred.shift_previous_solution(traj)
        const_vel = pred.constant_velocity_traj(pos, vel, self.M, self.n,
                                                p.dt)
        init = torch.where(seq >= 1, shifted, const_vel)
        return init, init

    def plan_block(self, pos, vel, acc, init, seq, pred_global,
                   obs_pos_global, obs_goal_global, obs_prev_global,
                   self_mask, radius, downwash, nominal_velocity, max_vel,
                   max_acc, desired_goal, rescue_goal=None,
                   rescue_active=None):
        """Plan one block of agents (L, ...) against the global obstacle
        view (N_total, ...): goals, K-NN pruning, LSC planes, QP.  Returns
        (QPResult, current_goal, knn_overflow, path_floor); knn_overflow
        (L,) flags agents whose K-th nearest neighbour is still inside the
        interaction ball (None without pruning)."""
        p = self.param
        L = pos.shape[0]
        O = pred_global.shape[0]
        M, n = self.M, self.n

        current_goal, path_floor = self.goal_planner.plan(
            pos=pos, vel=vel, init_traj=init, desired_goal=desired_goal,
            seq=seq, radius=radius, downwash=downwash,
            obs_pos=obs_pos_global, obs_goal=obs_goal_global,
            obs_prev_traj=obs_prev_global, self_mask=self_mask,
            obs_radius=self.radius, obs_downwash=self.downwash)
        if rescue_goal is not None and rescue_active is not None:
            current_goal = torch.where(rescue_active[:, None], rescue_goal,
                                       current_goal)

        K = p.max_neighbors
        knn_overflow = None
        if 0 < K < O:
            # K-NN pruning of the LSC pairs (simulator.py:611-662); an
            # index gather replaces the TPU's one-hot selection matmul
            sel_d2, nbr = knn_select(pos, obs_pos_global, self_mask, K)
            r2 = self._knn_cutoff * self._knn_cutoff
            knn_overflow = sel_d2[:, -1] < r2
            obs_pred = pred_global[nbr]                     # (L, K, M, n1, 3)
            obs_radius, obs_downwash = self.radius[nbr], self.downwash[nbr]
            obs_mask = sel_d2 <= r2
            O = K
        else:
            obs_pred = pred_global[None].expand(L, O, M, n + 1, 3)
            obs_radius = self.radius[None, :].expand(L, O)
            obs_downwash = self.downwash[None, :].expand(L, O)
            obs_mask = ~self_mask
        planes = cons.lsc_planes(
            init, obs_pred, radius, downwash, obs_radius, obs_downwash,
            torch.ones((L, O), dtype=torch.bool, device=pos.device),
            obs_mask, guard_margin=p.lsc_guard_margin)
        planes = cons.concat_planes(planes, n_ctrl=n + 1)

        # warm start from the (feasible) shifted previous solution
        y_warm = self.optimizer.extract_y(init).to(self.dtype)
        res = self.optimizer.solve(
            pos, vel, acc, current_goal, nominal_velocity=nominal_velocity,
            max_vel=max_vel, max_acc=max_acc, planes=planes,
            world_min=self.world_min, world_max=self.world_max,
            y_warm=y_warm, dtype=self.dtype)
        return res, current_goal, knn_overflow, path_floor

    def _patrol_swap(self, state: SwarmState, pos):
        """PATROL: swap start and desired goal at the goal
        (traj_planner.cpp:479-485)."""
        if not self.param.multisim_patrol:
            return state.start, state.desired_goal
        near = (_norm(pos - state.desired_goal) <
                self.param.goal_threshold)[:, None]
        return (torch.where(near, state.desired_goal, state.start),
                torch.where(near, state.start, state.desired_goal))

    # ------------------------------------------------------------------
    def cycle(self, state: SwarmState):
        """One synchronous planning cycle for all agents.
        Returns (new_state, CycleInfo)."""
        p = self.param
        pos, vel, acc = self.propagate(state)
        start, desired_goal = self._patrol_swap(state, pos)

        goal_changed = (desired_goal != state.desired_goal).any(-1)
        best_prev = torch.where(goal_changed, float("inf"),
                                state.best_goal_dist)
        stall_count, progress, progress_best, best_goal_dist = \
            _update_stall_count(state.stall_count, best_prev, state.pos,
                                pos, vel, desired_goal, state.seq, p)
        if p.deadlock_rescue:
            rescue_goal, rescue_active, rescue_phase, stall_count = \
                _update_rescue(state, pos, desired_goal, stall_count,
                               progress, p, radius=self.radius,
                               world_min=self.world_min,
                               world_max=self.world_max,
                               progress_best=progress_best)
        else:
            rescue_goal, rescue_active, rescue_phase = _no_rescue(state)

        init, prediction = self.predict_and_init(state.traj, pos, vel,
                                                 state.seq)
        res, current_goal, knn_overflow, path_floor = self.plan_block(
            pos, vel, acc, init, state.seq, pred_global=prediction,
            obs_pos_global=pos, obs_goal_global=desired_goal,
            obs_prev_global=state.traj, self_mask=self.self_mask,
            radius=self.radius, downwash=self.downwash,
            nominal_velocity=self.nominal_velocity, max_vel=self.max_vel,
            max_acc=self.max_acc, desired_goal=desired_goal,
            rescue_goal=rescue_goal, rescue_active=rescue_active)

        # QPFAILED report + feasible fallback (simulator.py:890-898): a
        # failing agent keeps its shifted previous solution
        qp_failed = res.primal_res > p.qp_failure_threshold
        traj = torch.where(qp_failed[:, None, None, None], init, res.traj)

        safety_step = audit.step_safety_ratio(
            traj, self.radius, self.downwash, p.dt,
            p.multisim_record_time_step, p.multisim_time_step)
        step_dist = audit.step_distance(
            traj, p.dt, p.multisim_record_time_step, p.multisim_time_step)

        new_state = SwarmState(
            traj=traj, pos=pos, vel=vel, acc=acc,
            current_goal=current_goal, seq=state.seq + 1,
            qp_cost=res.cost, primal_res=res.primal_res,
            safety_agent_min=torch.minimum(state.safety_agent_min,
                                           safety_step),
            distance=state.distance + step_dist,
            sfc=state.sfc,
            sfc_initialized=torch.ones_like(state.sfc_initialized),
            start=start, desired_goal=desired_goal,
            safety_obs_min=state.safety_obs_min,
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

    # ------------------------------------------------------------------
    def qp_violation_report(self, prev_state: SwarmState,
                            state: SwarmState, top_k: int = 5) -> dict:
        """Each failing agent's most violated (obstacle, segment, ctrl
        point) LSC rows for the cycle prev_state -> state (host-side
        diagnostic, simulator.py:1149-1188)."""
        p = self.param
        N = self.N
        pos, vel, _ = self.propagate(prev_state)
        init, prediction = self.predict_and_init(prev_state.traj, pos, vel,
                                                 prev_state.seq)
        planes = cons.lsc_planes(
            init, prediction[None].expand(N, *prediction.shape),
            self.radius, self.downwash,
            self.radius[None].expand(N, N), self.downwash[None].expand(N, N),
            torch.ones((N, N), dtype=torch.bool, device=self.device),
            ~self.self_mask, guard_margin=p.lsc_guard_margin)
        lhs = torch.einsum("ncmd,nmid->ncmi", planes.normal, state.traj)
        viol = torch.where(planes.mask[..., None], planes.rhs - lhs,
                           float("-inf"))
        v = viol.cpu().numpy()
        report = {}
        failed = state.primal_res.cpu().numpy() > p.qp_failure_threshold
        for qi in np.where(failed)[0]:
            flat = v[qi].reshape(-1)
            rows = []
            for r in np.argsort(flat)[::-1][:top_k]:
                c, rem = divmod(int(r), self.M * (self.n + 1))
                m, i = divmod(rem, self.n + 1)
                rows.append({"obstacle": c, "segment": m, "ctrl_pt": i,
                             "violation": float(flat[r])})
            report[int(qi)] = rows
        return report

    def is_finished(self, state: SwarmState) -> bool:
        """All agents within goal_threshold of their desired goals; never
        in patrol mode."""
        if self.param.multisim_patrol:
            return False
        d = _norm(state.pos - state.desired_goal)
        return bool(d.max() < self.param.goal_threshold)

    def run(self, max_iterations: Optional[int] = None, log=None,
            profile: bool = False, steps_per_dispatch: int = 1) -> dict:
        """Host loop: cycle until every agent reaches its goal or the
        iteration cap.  Returns the summary dict of the JAX package's run
        (stage_times stays empty)."""
        if log is not None or profile:
            raise NotImplementedError("cycle logs and stage profiles are "
                                      "not ported (ROADMAP queue 1, "
                                      "item 14)")
        if steps_per_dispatch != 1:
            raise NotImplementedError("several cycles per dispatch (CUDA "
                                      "graph capture) is not ported "
                                      "(ROADMAP queue 1, item 7)")
        p = self.param
        max_iter = max_iterations or p.multisim_max_planner_iteration
        state = self.initial_state()
        t_wall0 = time.perf_counter()
        plan_times = []
        is_collided = False
        flight_time = float("nan")
        iters_done = 0
        qp_failures = 0
        for it in range(max_iter):
            prev_state = state
            t0 = time.perf_counter()
            state, info = self.cycle(state)
            # one device->host read per cycle
            safety, n_failed, goal_dist = torch.stack([
                info.safety_step_min.double(),
                info.qp_failed.sum().double(),
                _norm(state.pos - state.desired_goal).max().double(),
            ]).tolist()
            plan_times.append(time.perf_counter() - t0)
            iters_done = it + 1
            if safety < 1.0:
                is_collided = True
            if n_failed:
                qp_failures += int(n_failed)
                report = self.qp_violation_report(prev_state, state)
                print(f"[SyncSimulator] QPFAILED at cycle {it}, agents "
                      f"{sorted(report)}; top violations: {report}")
                if p.multisim_abort_on_qp_failure:
                    print("[SyncSimulator] aborting run "
                          "(multisim_abort_on_qp_failure)")
                    break
            if not p.multisim_patrol and goal_dist < p.goal_threshold:
                flight_time = iters_done * p.multisim_time_step
                break
            if p.multisim_planning_rate > 0:
                time.sleep(1.0 / p.multisim_planning_rate)
        synchronize(self.device)
        wall = time.perf_counter() - t_wall0
        pt = np.asarray(plan_times[1:]) if len(plan_times) > 1 else \
            np.asarray(plan_times)
        return self._summarize(state, pt, wall, iters_done, flight_time,
                               is_collided, qp_failures)

    def _summarize(self, state, pt, wall, iters_done, flight_time,
                   is_collided, qp_failures: int = 0) -> dict:
        p = self.param
        return {
            "stage_times": {},
            "total_flight_time": flight_time,
            "total_flight_distance": float(state.distance),
            "is_collided": bool(is_collided),
            "safety_ratio_agent": float(state.safety_agent_min),
            "safety_ratio_obs": float(state.safety_obs_min),
            "average_planning_time": float(pt.mean()) if pt.size else 0.0,
            "min_planning_time": float(pt.min()) if pt.size else 0.0,
            "max_planning_time": float(pt.max()) if pt.size else 0.0,
            "iterations": iters_done,
            "qp_failures": qp_failures,
            "wall_time": wall,
            "planner_mode": p.planner_mode_str(),
            "final_state": state,
        }
