"""Synchronous multi-agent replanning simulator (port of
lsc_planner_tpu/sim/simulator.py).

One cycle for the whole swarm: propagate the previous solutions one time
step, stall/rescue bookkeeping, prediction, the goal rule, the planner
mode's planes (LSC, BVC or reciprocal RSFC), the batched trajectory QP,
the QPFAILED fallback and the sampled safety audit; the ORCA planner
flies a straight line at each agent's ORCA velocity (ops/orca.py) and
solves no QP. RSFC, and LSC in
experiment mode, solve the slack-relaxed QP; experiment mode also takes
external poses (``inject_positions``): a deviated agent restarts from its
observed position, re-seeds its SFC and slacks its rows in the next cycle,
whose other agents slack the rows of the deviated one. In a static world
(an ``esdf``, or mission ``static`` boxes folded into one) the goal rule
plans on the wavefront grid, each agent's SFC box corridor is updated and
its faces join the LSC rows, deadlock-rescue waypoints are ray-checked
against the ESDF, and the static boxes are audited exactly. The tables
live as tensors on the simulator's device (the CUDA device unless the
caller names another) and are made once; on the card a cycle syncs with
the host only for the QP's factored-path exit read, and ``run`` reads one
small stats tensor back per cycle. ``run(steps_per_dispatch=k)`` runs k
cycles a dispatch (``make_scan_cycle``, the JAX package's ``lax.scan``):
on the card one CUDA graph of k cycles, with one host read a block.

With ``max_neighbors = K`` (0 < K < N) each agent keeps LSC rows only for
its K nearest neighbours, and the cycle reports the density-overflow audit
of that pruning in ``CycleInfo.knn_overflow``.

Mission dynamic obstacles (every obstacle kind but ``static``) are
evaluated on the host each cycle, as in the JAX package: ``run`` steps the
obstacle models (chasing ones after the nearest agent, which reads the
agents' positions back), runs the Kalman filters or the oracle's
Bernstein fit of the prediction mode, and hands the cycle their positions,
velocities and predictions, which join each agent's LSC rows after its
agent columns.  Several cycles a dispatch refuse them with ValueError.

``run(log=...)`` writes the reference's result CSV through
sim/logging.py's ResultLogger, and ``run(profile=True)`` adds
``profile_stages``' per-stage times to the summary.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from ..config import (GoalMode, InitialTrajMode, Param, PlannerMode,
                      PredictionMode)
from ..missions import Mission
from ..device import resolve_device, synchronize
from ..ops import bernstein as bz
from ..ops import chol, ipm, wavefront
from ..ops import corridor as corridor_ops
from ..ops import lsc_planes as lsc_ops
from ..ops import orca as orca_ops
from ..ops.geometry import knn_select
from ..planner import constraints as cons
from ..planner import goal as goal_mod
from ..planner import prediction as pred
from ..planner.optimizer import SlackSpec, TrajOptimizer
from ..world.corridor import CorridorBuilder, update_sfc
from ..world.esdf import ESDF
from . import audit
from .kalman import LinearKalmanFilter
from .obstacles import ChasingObstacle, ObstacleGenerator


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


# profile_stages' keys (the JAX package's) and the tracer's stages in each
STAGE_KEYS = {"obstacle_prediction": ("propagate", "predict"),
              "initial_traj": (),       # shared with the prediction
              "goal_planning": ("goal",),
              "lsc_generation": ("planes",),
              "sfc_generation": ("sfc",),
              "traj_optimization": ("qp_assembly", "ipm")}


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


def reset_launch_counts() -> None:
    """Sets every kernel wrapper's launch counter (ops/*.py) to 0."""
    for mod in (chol, ipm, wavefront, corridor_ops, lsc_ops):
        mod.reset_counts()


def launch_counts() -> dict:
    """The kernel wrappers' launch counters (ops/*.py), by kernel."""
    return {"factor_solve": chol.factor_solve_launches,
            "resolve": chol.resolve_launches,
            "cholesky_batched": chol.factor_launches,
            "factor_solve_cluster": chol.factor_solve_cluster_launches,
            "resolve_cluster": chol.resolve_cluster_launches,
            "cholesky_batched_cluster": chol.factor_cluster_launches,
            "factor_solve_tiled": chol.factor_solve_tiled_launches,
            "resolve_tiled": chol.resolve_tiled_launches,
            "cholesky_batched_tiled": chol.factor_tiled_launches,
            "fused_ipm": ipm.fused_launches,
            "wavefront": wavefront.wavefront_launches,
            "expand_boxes": corridor_ops.expand_launches,
            "lsc_planes": lsc_ops.lsc_planes_launches}


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


class _CycleGraph:
    """k cycles of a simulator as one CUDA graph (make_scan_cycle on the
    card).  Captured at construction from the shapes of `state`: one
    uncaptured warm-up cycle on a side stream first builds the kernel
    library, the fused IPM's plan and every cached constant (none may be
    made inside the graph), then k cycles are captured.  Their inputs are
    static buffers (one a SwarmState field), their stacked outputs live in
    the graph's pool, and the graph's last nodes copy state_k back into
    the static inputs, so each replay advances k cycles.
    ``launches``: the kernel launches one replay makes (the counters'
    increase during capture; a replay moves no counter).
    ``trace``: the tracer's recording of the capture's stage stamps and
    counters (each replay rewrites them; trace.stamps(graph) reads them),
    None when it was captured with tracing off.  The set-up spans
    graph.warm_up and graph.capture (the capture and instantiation) time
    the construction."""

    def __init__(self, sim, k, state):
        dev = sim.device
        self.static = SwarmState(*[None if f is None else f.clone()
                                   for f in state])
        self.trace = trace.new_recording(dev)
        with trace.setup_span("graph.warm_up"), trace.recording(self.trace):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                sim.cycle(self.static)
            torch.cuda.current_stream(dev).wait_stream(side)
            synchronize(dev)
        if self.trace is not None:
            self.trace.reset()
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with trace.setup_span("graph.capture"), \
                trace.recording(self.trace):
            # no garbage collection while capturing: an unreachable graph
            # of an earlier capture, collected now, would destroy its CUDA
            # graph, which a capturing stream forbids (the capture would
            # fail)
            gc_enabled = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    out, self.outputs = _stack_cycles(sim.cycle,
                                                      self.static, k)
                    pairs = [(dst, src) for dst, src in zip(self.static, out)
                             if dst is not None and src is not dst]
                    # an output that shares memory with a static buffer is
                    # copied first, so that no copy below reads a buffer
                    # already written
                    held = {f.untyped_storage().data_ptr()
                            for f in self.static if f is not None}
                    pairs = [(dst, src.clone()
                              if src.untyped_storage().data_ptr() in held
                              else src) for dst, src in pairs]
                    for dst, src in pairs:
                        dst.copy_(src)
                    trace.mark(trace.END)
            finally:
                if gc_enabled:
                    gc.enable()
            synchronize(dev)
        after = launch_counts()
        self.launches = {name: after[name] - before[name] for name in after}

    def __call__(self, state):
        if any(a is not b for a, b in zip(state, self.static)):
            with trace.span("graph.copy_inputs"):
                for dst, src in zip(self.static, state):
                    if dst is not None:
                        dst.copy_(src)
        with trace.span("graph.replay"):
            self.graph.replay()
        return self.static, self.outputs


class _ScanCycle:
    """make_scan_cycle's multi on the card: replays the simulator's graph of
    k cycles for the state's shapes (SyncSimulator.cycle_graph).
    ``graph`` is the _CycleGraph the last call replayed."""

    def __init__(self, sim, k):
        self.sim, self.k, self.graph = sim, k, None

    def __call__(self, state):
        self.graph = self.sim.cycle_graph(self.k, state)
        return self.graph(state)


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
    esdf: object = None           # world.esdf.ESDF of a static world

    def __post_init__(self):
        self.param = self.param.validated()
        p = self.param
        self.device = resolve_device(self.device)
        self.N = self.mission.qn
        self.M, self.n = p.M, p.n
        # make_scan_cycle's CUDA graphs by (k, the tracer's switch, the
        # state's shapes and dtypes)
        self._graphs = {}
        static_specs = [o for o in self.mission.obstacles
                        if o.kind == "static"]
        dyn_specs = [o for o in self.mission.obstacles
                     if o.kind != "static"]
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

        with trace.setup_span("sim.tables"):
            self._tables(arrs, static_specs, dyn_specs, t)

    def _tables(self, arrs, static_specs, dyn_specs, t):
        """The world's tables, made once: the ESDF with the static boxes,
        the corridor builder, the dynamic obstacles' generator and the goal
        planner's grids."""
        p = self.param
        # static boxes are world geometry (simulator.py:351-380): folded
        # into the ESDF, so the corridor, the grid planner, the rescue ray
        # checks and the compatibility gate see them, and audited exactly
        if self.esdf is not None:
            self.esdf = self.esdf.to(device=self.device)
        if static_specs:
            boxes = np.stack([
                np.concatenate([np.asarray(o.pose, float) -
                                np.asarray(o.dimensions, float),
                                np.asarray(o.pose, float) +
                                np.asarray(o.dimensions, float)])
                for o in static_specs])
            self.static_boxes = t(boxes)
            if self.esdf is not None:
                self.esdf = self.esdf.merge_boxes(boxes)
            else:
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

        # dynamic obstacles (obstacle_generator.hpp analog), evaluated on the
        # host each cycle; static boxes are world geometry above
        self.obstacle_generator = None
        self.O_dyn = len(dyn_specs)
        self._kf = None
        if self.O_dyn:
            self.obstacle_generator = ObstacleGenerator(
                dataclasses.replace(self.mission, obstacles=dyn_specs),
                noise_std=p.obs_observer_stddev)
            gen = self.obstacle_generator
            radii, dw, acc = gen.radii, gen.downwash, gen.max_acc
        else:
            radii, dw, acc = np.zeros(0), np.ones(0), np.zeros(0)
        self.obs_radius_dyn = t(radii)
        self.obs_downwash_dyn = t(dw)
        # the obstacles' acceleration bounds size their slack and RSFC rows
        self.obs_max_acc_dyn = t(acc)
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

    def orca_velocities(self, pos, vel, current_goal):
        """All-agent ORCA velocities with the reference's parameters
        (updateORCAVelocity, traj_planner.cpp:1063-1223): radius inflated
        by orca_inflation_ratio, the preferred velocity toward the current
        goal capped at max_vel * orca_pref_velocity_ratio (with the
        reference's squared-norm-against-speed test, kept for parity),
        and v_z pinned to 0 in a 2-D world."""
        p = self.param
        pref_speed = self.max_vel[:, 0] * p.orca_pref_velocity_ratio
        gvec = current_goal - pos
        too_fast = (gvec * gvec).sum(-1) > pref_speed
        gnorm = _norm(gvec, keepdim=True)
        gvec = torch.where(too_fast[:, None],
                           gvec / torch.clamp(gnorm, min=1e-9) *
                           pref_speed[:, None], gvec)
        return orca_ops.orca_velocities(
            pos, vel, self.radius * p.orca_inflation_ratio,
            pref_vel=gvec, max_speed=pref_speed,
            is_dynamic=torch.zeros((self.N,), dtype=torch.bool,
                                   device=pos.device),
            time_horizon=p.orca_horizon, time_step=0.5,
            force_z_zero=(p.world_dimension == 2))

    def _traj_for_mode(self, mode, traj, pos, vel, seq, prev_goal=None):
        """The trajectory of a prediction or initial-trajectory mode
        (traj_planner.cpp:610-1061, simulator.py:509-553)."""
        p = self.param
        if mode == InitialTrajMode.GREEDY:
            # straight toward the previous cycle's current goal at the
            # nominal velocity, held at the ideal flight time
            # (initialTrajPlanningGreedy, traj_planner.cpp:983-995)
            goal = prev_goal if prev_goal is not None else pos
            delta = goal - pos
            dist = _norm(delta, keepdim=True)
            dirn = delta / torch.clamp(dist, min=1e-9)
            t_ideal = dist / torch.clamp(self.nominal_velocity[:, None],
                                         min=1e-9)
            m = torch.arange(self.M, dtype=pos.dtype,
                             device=pos.device)[:, None]
            i = torch.arange(self.n + 1, dtype=pos.dtype,
                             device=pos.device)[None, :]
            tau = (m + i / self.n) * p.dt                    # (M, n+1)
            t_held = torch.minimum(tau[None, :, :, None],
                                   t_ideal[:, None, None, :])
            return pos[:, None, None, :] + dirn[:, None, None, :] * \
                self.nominal_velocity[:, None, None, None] * t_held
        if mode in (PredictionMode.PREVIOUS_SOLUTION,
                    InitialTrajMode.PREVIOUS_SOLUTION,
                    InitialTrajMode.SKIP):
            # SKIP (the reference's debugger mode) is the shift here too
            shifted = pred.shift_previous_solution(traj)
            const_vel = pred.constant_velocity_traj(pos, vel, self.M,
                                                    self.n, p.dt)
            return torch.where(seq >= 1, shifted, const_vel)
        if mode in (PredictionMode.VELOCITY, InitialTrajMode.VELOCITY,
                    PredictionMode.ORACLE,
                    PredictionMode.LINEAR_KALMAN_FILTER):
            # the oracle and the filter refine the dynamic obstacles'
            # predictions (on the host, dynamic_inputs); agents predict each
            # other at constant velocity (traj_planner.cpp:741-749)
            return pred.constant_velocity_traj(pos, vel, self.M, self.n,
                                               p.dt)
        if mode in (PredictionMode.POSITION, InitialTrajMode.POSITION):
            return pred.constant_position_traj(pos, self.M, self.n)
        # the ORCA prediction and initial-trajectory modes: the JAX package
        # raises NotImplementedError(mode) on them too
        raise NotImplementedError(f"{type(mode).__name__} {mode.value}: "
                                  "the JAX package has no such mode either")

    def predict_and_init(self, traj, pos, vel, seq, prev_goal=None):
        """Obstacle prediction and initial trajectory, in the modes that
        self.param names when called (a test may set them after
        validated(), as the JAX package's do).  Under the previous-solution
        modes one tensor is both.  Returns (init, prediction)."""
        p = self.param
        prediction = self._traj_for_mode(p.prediction_mode, traj, pos, vel,
                                         seq)
        if p.initial_traj_mode.value == p.prediction_mode.value:
            return prediction, prediction
        init = self._traj_for_mode(p.initial_traj_mode, traj, pos, vel,
                                   seq, prev_goal=prev_goal)
        return init, prediction

    def plan_block(self, pos, vel, acc, init, seq, pred_global,
                   obs_pos_global, obs_goal_global, obs_prev_global,
                   self_mask, radius, downwash, nominal_velocity, max_vel,
                   max_acc, desired_goal, sfc_prev=None, sfc_initialize=None,
                   sfc_seed=None, rescue_goal=None, rescue_active=None,
                   dyn_pos=None, dyn_vel=None, dyn_pred=None,
                   obs_slack_global=None, self_slack=None,
                   obs_radius_global=None, obs_downwash_global=None,
                   obs_maxacc_global=None):
        """Plan one block of agents (L, ...) against the global obstacle
        view (N_total, ...): goals, K-NN pruning, the dynamic obstacles'
        columns after the agents', LSC planes, the SFC corridor in a static
        world, QP.  dyn_pred is (O_dyn, M, n+1, 3), or per agent (L, O_dyn,
        M, n+1, 3); without it the dynamic obstacles are predicted at
        constant velocity from dyn_pos, dyn_vel.  Returns (QPResult,
        current_goal, sfc, knn_overflow, path_floor); knn_overflow (L,)
        flags agents whose K-th nearest neighbour is still inside the
        interaction ball (None without pruning); sfc is sfc_prev without a
        static world.  obs_slack_global (N_total,) flags the obstacles whose
        rows take slack and self_slack (L,) the agents that slack all their
        rows (experiment mode; both None otherwise).  obs_*_global (N_total,)
        replace the swarm's radius, downwash and acceleration bound of the
        view's columns where the view is not the whole swarm in agent order
        (the ring-halo view of parallel/shard.py)."""
        p = self.param
        L = pos.shape[0]
        O = pred_global.shape[0]
        M, n = self.M, self.n
        obs_radius_all = (self.radius if obs_radius_global is None
                          else obs_radius_global)
        obs_downwash_all = (self.downwash if obs_downwash_global is None
                            else obs_downwash_global)
        obs_maxacc_all = (self.max_acc[:, 0] if obs_maxacc_global is None
                          else obs_maxacc_global)

        trace.mark("goal")
        current_goal, path_floor = self.goal_planner.plan(
            pos=pos, vel=vel, init_traj=init, desired_goal=desired_goal,
            seq=seq, radius=radius, downwash=downwash,
            obs_pos=obs_pos_global, obs_goal=obs_goal_global,
            obs_prev_traj=obs_prev_global, self_mask=self_mask,
            obs_radius=obs_radius_all, obs_downwash=obs_downwash_all)
        if rescue_goal is not None and rescue_active is not None:
            current_goal = torch.where(rescue_active[:, None], rescue_goal,
                                       current_goal)

        trace.mark("planes")
        K = p.max_neighbors
        knn_overflow = None
        if 0 < K < O:
            # K-NN pruning of the LSC pairs (simulator.py:611-662); an
            # index gather replaces the TPU's one-hot selection matmul
            sel_d2, nbr = knn_select(pos, obs_pos_global, self_mask, K)
            r2 = self._knn_cutoff * self._knn_cutoff
            knn_overflow = sel_d2[:, -1] < r2
            obs_pred = pred_global[nbr]                     # (L, K, M, n1, 3)
            obs_radius = obs_radius_all[nbr]
            obs_downwash = obs_downwash_all[nbr]
            obs_max_acc = obs_maxacc_all[nbr]
            obs_mask = sel_d2 <= r2
            obs_slack = (obs_slack_global[nbr]
                         if obs_slack_global is not None else None)
            O = K
        else:
            obs_pred = pred_global[None].expand(L, O, M, n + 1, 3)
            obs_radius = obs_radius_all[None, :].expand(L, O)
            obs_downwash = obs_downwash_all[None, :].expand(L, O)
            obs_max_acc = obs_maxacc_all[None, :].expand(L, O)
            obs_mask = ~self_mask
            obs_slack = (obs_slack_global[None, :].expand(L, O)
                         if obs_slack_global is not None else None)
        dev = pos.device
        obs_is_agent = torch.ones((L, O), dtype=torch.bool, device=dev)

        # the mission's dynamic obstacles after the agent columns
        # (simulator.py:675-710; non-agents take constant-velocity
        # predictions, traj_planner.cpp:838-847, unless the oracle or a
        # per-agent filter hands in its own)
        if self.O_dyn and dyn_pos is not None:
            Od = self.O_dyn
            if dyn_pred is None:
                dyn_pred = pred.constant_velocity_traj(dyn_pos, dyn_vel, M,
                                                       n, p.dt)
            obs_pred = torch.cat([obs_pred, dyn_pred.expand(
                L, Od, M, n + 1, 3)], dim=1)
            obs_is_agent = torch.cat([obs_is_agent, torch.zeros(
                (L, Od), dtype=torch.bool, device=dev)], dim=1)
            obs_mask = torch.cat([obs_mask, torch.ones(
                (L, Od), dtype=torch.bool, device=dev)], dim=1)
            obs_radius = torch.cat(
                [obs_radius, self.obs_radius_dyn[None].expand(L, Od)], dim=1)
            obs_downwash = torch.cat(
                [obs_downwash, self.obs_downwash_dyn[None].expand(L, Od)],
                dim=1)
            obs_max_acc = torch.cat(
                [obs_max_acc, self.obs_max_acc_dyn[None].expand(L, Od)],
                dim=1)
            if obs_slack is not None:
                # host-built predictions start at the observed positions:
                # the deviation gate never fires for them (JAX
                # simulator.py:704-709)
                obs_slack = torch.cat([obs_slack, torch.zeros(
                    (L, Od), dtype=torch.bool, device=dev)], dim=1)

        if p.prediction_mode == PredictionMode.VELOCITY:
            # linear-prediction slow-down (generateLSC preamble,
            # traj_planner.cpp:1310-1330): colliding straight-line
            # predictions are contracted so the LSC margins stay feasible
            alpha = pred.linear_prediction_slowdown(
                init, obs_pred, radius, obs_radius, obs_mask,
                horizon=M * p.dt,
                esdf=self.goal_planner.esdf if p.world_use_octomap else None)
            init = pred.contract_trajectories(init, alpha)
            obs_pred = pred.contract_trajectories(obs_pred, alpha[:, None])

        slack_spec = None
        if p.planner_mode == PlannerMode.LSC:
            slack_flags = sizes = None
            if obs_slack is not None and self_slack is not None:
                # the disturbance path (simulator.py:727-747): a deviated
                # agent slacks all its rows, everyone the deviated
                # obstacle's; slacked non-agents take the RSFC margin
                slack_flags = (obs_slack | self_slack[:, None]) & obs_mask
                sizes = pred.obstacle_size_prediction(
                    obs_radius, obs_max_acc, M, n, p.dt,
                    p.obs_uncertainty_horizon, p.obs_size_prediction)
                slack_spec = SlackSpec(mode="collision", enable=slack_flags,
                                       n_slack_c=obs_pred.shape[1],
                                       weight=p.slack_collision_weight)
            planes = cons.lsc_planes(
                init, obs_pred, radius, downwash, obs_radius, obs_downwash,
                obs_is_agent, obs_mask, slack_flags=slack_flags,
                obs_pred_sizes=sizes, guard_margin=p.lsc_guard_margin)
        elif p.planner_mode == PlannerMode.BVC:
            planes = cons.bvc_planes(init, obs_pred, radius, downwash,
                                     obs_radius, obs_downwash, obs_is_agent,
                                     obs_mask)
        else:       # RECIPROCAL_RSFC (simulator.py:753-765)
            sizes = pred.obstacle_size_prediction(
                obs_radius, obs_max_acc, M, n, p.dt,
                p.obs_uncertainty_horizon, p.obs_size_prediction)
            planes = cons.rsfc_planes(init, obs_pred, sizes, radius,
                                      downwash, obs_radius, obs_downwash,
                                      obs_is_agent, obs_mask)
            slack_spec = SlackSpec(mode="collision", enable=obs_mask,
                                   n_slack_c=obs_pred.shape[1],
                                   weight=p.slack_collision_weight)

        # SFC corridors against the static world (generateFeasibleSFC,
        # traj_planner.cpp:1451-1491), their faces after the LSC rows
        trace.mark("sfc")
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
        trace.mark("qp_assembly")
        y_warm = self.optimizer.extract_y(init).to(self.dtype)
        res = self.optimizer.solve(
            pos, vel, acc, current_goal, nominal_velocity=nominal_velocity,
            max_vel=max_vel, max_acc=max_acc, planes=planes,
            world_min=self.world_min, world_max=self.world_max,
            y_warm=y_warm, slack=slack_spec, dtype=self.dtype)
        return res, current_goal, sfc, knn_overflow, path_floor

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
    def cycle(self, state: SwarmState, dyn_pos=None, dyn_vel=None,
              dyn_pred=None):
        """One synchronous planning cycle for all agents, with the dynamic
        obstacles' positions and velocities (O_dyn, 3) and, from the oracle
        or the per-agent filters, their predictions (dynamic_inputs gives
        all three; without them the obstacles sit at the origin, as in the
        JAX package).  Returns (new_state, CycleInfo).  Each stage starts
        with its mark (trace.STAGES; no-ops unless tracing)."""
        p = self.param
        trace.mark("propagate")
        if self.O_dyn and dyn_pos is None:
            dyn_pos = torch.zeros((self.O_dyn, 3), dtype=self.dtype,
                                  device=self.device)
            dyn_vel = torch.zeros_like(dyn_pos)
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
                               progress, p, esdf=self.esdf,
                               radius=self.radius,
                               world_min=self.world_min,
                               world_max=self.world_max,
                               progress_best=progress_best)
        else:
            rescue_goal, rescue_active, rescue_phase = _no_rescue(state)

        if p.planner_mode == PlannerMode.ORCA:
            return self._cycle_orca(state, pos, vel, acc, start,
                                    desired_goal)

        trace.mark("predict")
        init, prediction = self.predict_and_init(state.traj, pos, vel,
                                                 state.seq,
                                                 prev_goal=state.current_goal)
        # SFC seed: the previous solution's endpoint, or the current
        # position on (re-)initialization (traj_planner.cpp:1454-1473)
        sfc_initialize = ~state.sfc_initialized
        obs_slack_global = self_slack = None
        if p.multisim_experiment and state.slack_flags is not None:
            # the disturbance-reset slack path (simulator.py:856-871): a
            # deviated agent's initial trajectory collapses to its position,
            # its SFC is re-seeded and it slacks all its rows; the agents
            # inject_positions flagged are slacked by everyone
            init, self_reset = pred.initial_traj_check(
                init, pos, p.multisim_reset_threshold)
            sfc_initialize = sfc_initialize | self_reset
            self_slack = state.slack_flags | self_reset
            obs_slack_global = state.slack_flags
        sfc_seed = torch.where(sfc_initialize[:, None], pos,
                               state.traj[:, -1, -1, :])
        res, current_goal, sfc, knn_overflow, path_floor = self.plan_block(
            pos, vel, acc, init, state.seq, pred_global=prediction,
            obs_pos_global=pos, obs_goal_global=desired_goal,
            obs_prev_global=state.traj, self_mask=self.self_mask,
            radius=self.radius, downwash=self.downwash,
            nominal_velocity=self.nominal_velocity, max_vel=self.max_vel,
            max_acc=self.max_acc, desired_goal=desired_goal,
            sfc_prev=state.sfc, sfc_initialize=sfc_initialize,
            sfc_seed=sfc_seed, rescue_goal=rescue_goal,
            rescue_active=rescue_active, dyn_pos=dyn_pos, dyn_vel=dyn_vel,
            dyn_pred=dyn_pred, obs_slack_global=obs_slack_global,
            self_slack=self_slack)

        trace.mark("audit")
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
        if self.O_dyn:
            safety_obs = torch.minimum(safety_obs,
                                       audit.obstacle_safety_ratio(
                                           pos, dyn_pos, self.radius,
                                           self.obs_radius_dyn))
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

    def _cycle_orca(self, state: SwarmState, pos, vel, acc, start,
                    desired_goal):
        """The ORCA planner mode (planORCA, traj_planner.cpp:375-387,
        simulator.py:951-999): the new trajectory is a straight line at the
        ORCA velocity; no QP.  Dynamic obstacles are not among the ORCA
        neighbours, as in the JAX package.  Its stage marks: goal, planes
        (the ORCA velocities; in the ORCA goal mode they belong to goal)
        and audit."""
        p = self.param
        trace.mark("goal")
        if p.goal_mode == GoalMode.ORCA:
            orca_v = self.orca_velocities(pos, vel, state.current_goal)
            current_goal, path_floor = self.goal_planner.plan(
                pos=pos, vel=vel, init_traj=state.traj,
                desired_goal=desired_goal, seq=state.seq,
                radius=self.radius, downwash=self.downwash, orca_vel=orca_v)
        else:
            current_goal, path_floor = self.goal_planner.plan(
                pos=pos, vel=vel, init_traj=state.traj,
                desired_goal=desired_goal, seq=state.seq,
                radius=self.radius, downwash=self.downwash,
                prev_traj=state.traj)
            trace.mark("planes")
            orca_v = self.orca_velocities(pos, vel, current_goal)

        trace.mark("audit")
        traj = pred.constant_velocity_traj(pos, orca_v, self.M, self.n, p.dt)
        safety_step = audit.step_safety_ratio(
            traj, self.radius, self.downwash, p.dt,
            p.multisim_record_time_step, p.multisim_time_step)
        step_dist = audit.step_distance(
            traj, p.dt, p.multisim_record_time_step, p.multisim_time_step)
        zeros = torch.zeros((self.N,), dtype=self.dtype, device=self.device)
        new_state = SwarmState(
            traj=traj, pos=pos, vel=vel, acc=acc,
            current_goal=current_goal, seq=state.seq + 1,
            qp_cost=zeros, primal_res=zeros,
            safety_agent_min=torch.minimum(state.safety_agent_min,
                                           safety_step),
            distance=state.distance + step_dist,
            sfc=state.sfc, sfc_initialized=state.sfc_initialized,
            start=start, desired_goal=desired_goal,
            safety_obs_min=state.safety_obs_min,
            stall_count=state.stall_count, rescue_goal=state.rescue_goal,
            rescue_active=state.rescue_active,
            rescue_phase=state.rescue_phase,
            slack_flags=state.slack_flags, path_floor=path_floor,
            best_goal_dist=state.best_goal_dist)
        # no QP, so no QPFAILED (the JAX package leaves the flags None)
        info = CycleInfo(safety_step_min=safety_step, qp_cost=zeros,
                         primal_res=zeros,
                         qp_failed=torch.zeros((self.N,), dtype=torch.bool,
                                               device=self.device))
        return new_state, info

    # ------------------------------------------------------------------
    def profile_stages(self, state: SwarmState, n_cycles: int = 5) -> dict:
        """Per-stage times with the reference's stage taxonomy
        (PlanningTimeStatistics, include/sp_const.hpp:89-128;
        simulator.py:1060-1146) from the tracer's stage marks: one warm-up
        cycle, then n_cycles cycles from `state` with stamps on (device
        stamps on the card, the host clock on the CPU); each key is the mean
        seconds a cycle of its stages (STAGE_KEYS), ``total`` their sum and
        ``cycle_fused_end_to_end`` the whole cycle, audit included."""
        self.cycle(state)                   # warm-up
        with trace.tracing(stamps=True), \
                trace.recording(self.device) as rec:
            for _ in range(n_cycles):
                self.cycle(state)
                trace.mark(trace.END)
        spent = collections.Counter()
        for stage, seconds in trace.durations(trace.stamps(rec)):
            spent[stage] += seconds / n_cycles
        times = {key: sum((spent[s] for s in stages), 0.0)
                 for key, stages in STAGE_KEYS.items()}
        times["total"] = sum(times.values())
        times["cycle_fused_end_to_end"] = sum(spent.values())
        return times

    # ------------------------------------------------------------------
    def qp_violation_report(self, prev_state: SwarmState,
                            state: SwarmState, top_k: int = 5) -> dict:
        """Each failing agent's most violated (obstacle, segment, ctrl
        point) LSC rows for the cycle prev_state -> state (host-side
        diagnostic, simulator.py:1149-1188)."""
        p = self.param
        N = self.N
        pos, vel, _ = self.propagate(prev_state)
        init, prediction = self.predict_and_init(
            prev_state.traj, pos, vel, prev_state.seq,
            prev_goal=prev_state.current_goal)
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

    # the mission services (multi_sync_simulator.cpp:696-728,
    # simulator.py:1201-1209)
    def update_goals(self, state: SwarmState, new_goals) -> SwarmState:
        """/update_goal: the desired goals (N, 3) swapped mid-mission."""
        return state._replace(desired_goal=torch.as_tensor(
            new_goals, dtype=self.dtype, device=self.device))

    def go_back(self, state: SwarmState) -> SwarmState:
        """GOBACK: every agent flies back to its mission start."""
        return state._replace(start=state.desired_goal,
                              desired_goal=state.start)

    def dynamic_inputs(self, t_sim: float, state: SwarmState):
        """The host's dynamic-obstacle step of the cycle at time t_sim
        (run(), simulator.py:1273-1321): chasing obstacles take the
        agent nearest to them in `state` as their goal (a read of
        state.pos), the models step to t_sim, and the prediction mode
        refines what the agents see: the Kalman filters (one a dynamic
        obstacle, or, with observation noise, one an agent and obstacle on
        that agent's own noisy observation, as the reference's planners
        each filter their own message) or the oracle's fit of the true
        motion.  The numpy f64 results are cast to the simulator's dtype
        where the JAX package casts them.  Returns (dyn_pos, dyn_vel,
        dyn_pred or None) on the simulator's device."""
        p = self.param
        gen = self.obstacle_generator
        chasers = [m for m in gen.models if isinstance(m, ChasingObstacle)]
        if chasers:
            host_pos = state.pos.cpu().numpy()
            for m in chasers:
                d = np.linalg.norm(host_pos - m.pos, axis=-1)
                m.set_goal_point(host_pos[int(np.argmin(d))])
        dp, dv = gen.update(t_sim)

        def t(a):       # a copy: the generator reuses its arrays
            return torch.tensor(a, dtype=self.dtype, device=self.device)
        dyn_pred = None
        if p.prediction_mode == PredictionMode.LINEAR_KALMAN_FILTER:
            per_agent = gen.noise_std > 0
            if self._kf is None:
                self._kf = LinearKalmanFilter(
                    self.N * self.O_dyn if per_agent else self.O_dyn,
                    p.filter_sigma_y_sq, p.filter_sigma_v_sq,
                    p.filter_sigma_a_sq)
            if per_agent:
                fp, fv = self._kf.filter(gen.observed(self.N).reshape(-1, 3),
                                         t_sim)
                shape = (self.N, self.O_dyn, 3)
                dyn_pred = pred.constant_velocity_traj(
                    t(fp.reshape(shape)), t(fv.reshape(shape)), self.M,
                    self.n, p.dt)
            else:
                dp, dv = self._kf.filter(gen.observed(), t_sim)
        if p.prediction_mode == PredictionMode.ORACLE:
            dyn_pred = t(self._oracle_prediction(t_sim))
        return t(dp), t(dv), dyn_pred

    def _oracle_prediction(self, t_sim: float) -> np.ndarray:
        """Perfect dynamic-obstacle prediction: the true model sampled over
        the horizon and fitted with Bernstein control points a segment
        (obstaclePredictionWithOracle, traj_planner.cpp:715-751).
        Returns (O_dyn, M, n+1, 3) float64."""
        p = self.param
        M, n = self.M, self.n
        basis = np.zeros((n + 1, n + 1))
        for r, tau in enumerate(np.linspace(0.0, 1.0, n + 1)):
            for i in range(n + 1):
                basis[r, i] = bz.nchoosek(n, i) * tau ** i * \
                    (1 - tau) ** (n - i)
        basis_inv = np.linalg.inv(basis)
        out = np.zeros((self.O_dyn, M, n + 1, 3))
        for oi, model in enumerate(self.obstacle_generator.models):
            if isinstance(model, ChasingObstacle):
                raise ValueError("oracle does not support chasing "
                                 "obstacles (traj_planner.cpp:719-721)")
            for m in range(M):
                targets = np.stack([
                    model.state(t_sim + (m + i / n) * p.dt)[0]
                    for i in range(n + 1)])
                out[oi, m] = basis_inv @ targets
        return out

    def inject_positions(self, state: SwarmState, real_pos) -> SwarmState:
        """Experiment-mode external poses (update(),
        multi_sync_simulator.cpp:210-246, simulator.py:1211-1231): an agent
        whose observed position (N, 3) is farther than the reset threshold
        from its plan one time step on restarts there (its trajectory
        frozen at the observation, its SFC re-seeded) and is flagged for
        the next cycle's slack-relaxed QP."""
        p = self.param
        real_pos = torch.as_tensor(real_pos, dtype=self.dtype,
                                   device=self.device)
        rolled = bz.traj_state_batch(state.traj, p.multisim_time_step, p.dt)
        dev = _norm(rolled["pos"] - real_pos) > p.multisim_reset_threshold
        frozen = real_pos[:, None, None, :].expand(state.traj.shape)
        slack = state.slack_flags
        if slack is not None:
            slack = slack | dev
        return state._replace(
            traj=torch.where(dev[:, None, None, None], frozen, state.traj),
            sfc_initialized=state.sfc_initialized & ~dev,
            slack_flags=slack)

    def make_scan_cycle(self, k: int):
        """k planning cycles in one dispatch (simulator.py:1001-1031, the
        JAX package's lax.scan).  Returns multi(state) -> (state_k,
        (CycleInfo stacked (k, ...), max_goal_dist (k,), cum_distance
        (k,))); the stacked goal distances and cumulative flight distance
        let the host recover the exact finishing cycle of a block.

        On the card multi replays one CUDA graph of k cycles (_CycleGraph),
        captured at the first call for the state's shapes and kept on the
        simulator by (k, shapes, dtypes) (``cycle_graph``); ``multi.graph``
        is the one the last call replayed (its ``launches`` a block and
        its tracer's ``trace``).  What it returns are the graph's own buffers,
        overwritten by the next call (clone what must outlive it); a state
        handed back in as it came out is not copied.  On the CPU multi runs
        the same k cycles eagerly: the tests' oracle, never taken by a CUDA
        simulator.  Dynamic obstacles, evaluated on the host each cycle,
        are refused with ValueError, as the JAX package refuses them."""
        if k < 1:
            raise ValueError(f"make_scan_cycle: k = {k} < 1")
        if self.obstacle_generator is not None:
            raise ValueError("several cycles a dispatch need device-only "
                             "state; dynamic obstacles are evaluated on the "
                             "host each cycle (use steps_per_dispatch=1)")
        if self.device.type != "cuda":
            def multi(state):
                out = _stack_cycles(self.cycle, state, k)
                trace.mark(trace.END)
                return out
            return multi
        return _ScanCycle(self, k)

    def cycle_graph(self, k: int, state: SwarmState) -> _CycleGraph:
        """The CUDA graph of k cycles for the shapes of `state` and the
        tracer's switch (a stamped graph is never replayed untraced),
        captured from it at the first call and kept on the simulator."""
        key = (k, trace.graph_key()) + tuple(None if f is None else (tuple(f.shape), f.dtype)
                           for f in state)
        if key not in self._graphs:
            self._graphs[key] = _CycleGraph(self, k, state)
        return self._graphs[key]

    def run(self, max_iterations: Optional[int] = None, log=None,
            cycle_fn=None, profile: bool = False,
            steps_per_dispatch: int = 1) -> dict:
        """Host loop: cycle until every agent reaches its goal or the
        iteration cap.  Returns the summary dict of the JAX package's run.
        `log` (a sim.logging.ResultLogger) records every cycle's CSV rows,
        the dynamic obstacles' with them; `profile` fills the summary's
        stage_times from profile_stages on the final state (left empty
        for the ORCA planner, as in the JAX package).
        `cycle_fn` replaces the cycle (simulator.py:1233-1261), such as the
        sharded cycle of parallel/shard.py.  A cycle_fn that runs on one
        rank of a mesh (it has ``shard``, ``gather`` and ``stats``, as
        ShardedCycle does) flies the rank's block of the initial state, and
        its ``stats`` give the loop's safety, QPFAILED count and goal
        distance for the whole swarm through one small collective; the
        state is gathered for chasing obstacles, the QPFAILED report, the
        log and the summary, so every rank returns the summary of the whole
        swarm.  Every rank then calls run alike (a log on every rank or on
        none): a gather is a collective.
        steps_per_dispatch = k > 1 runs blocks of k cycles a dispatch
        (make_scan_cycle, simulator.py:1233-1259): the finishing cycle is
        still recovered exactly from the per-cycle goal distances, but
        cycle_fn, per-cycle logs, dynamic obstacles and pacing are refused
        with ValueError, and the reported safety and QPFAILED count include
        the cycles planned after the finish in its block."""
        p = self.param
        if steps_per_dispatch > 1:
            if cycle_fn is not None or log is not None or \
                    p.multisim_experiment or \
                    self.obstacle_generator is not None or \
                    p.multisim_planning_rate > 0:
                raise ValueError("steps_per_dispatch > 1 is incompatible "
                                 "with cycle_fn/log/dynamic obstacles/"
                                 "experiment mode/real-time pacing")
            return self._run_fused(max_iterations, steps_per_dispatch,
                                   profile)
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch = {steps_per_dispatch} "
                             "< 1")
        cycle = cycle_fn or self.cycle
        ranked = all(hasattr(cycle_fn, a) for a in ("shard", "gather",
                                                    "stats"))
        whole = cycle_fn.gather if ranked else (lambda s: s)
        chasing = self.obstacle_generator is not None and any(
            isinstance(m, ChasingObstacle)
            for m in self.obstacle_generator.models)
        max_iter = max_iterations or p.multisim_max_planner_iteration
        state = self.initial_state()
        if ranked:
            state = cycle_fn.shard(state)
        t_wall0 = time.perf_counter()
        plan_times = []
        is_collided = False
        flight_time = float("nan")
        iters_done = 0
        qp_failures = 0
        for it in range(max_iter):
            prev_state = state
            t0 = time.perf_counter()
            with trace.span("run.dispatch"):
                if self.obstacle_generator is not None:
                    dyn = self.dynamic_inputs(it * p.multisim_time_step,
                                              whole(state) if chasing
                                              else state)
                    state, info = cycle(state, *dyn)
                else:
                    state, info = cycle(state)
            # one device->host read per cycle
            with trace.span("run.read"):
                if ranked:
                    stats = cycle_fn.stats(state, info)
                else:
                    stats = torch.stack([
                        info.safety_step_min.double(),
                        info.qp_failed.sum().double(),
                        _norm(state.pos - state.desired_goal).max().double()])
                safety, n_failed, goal_dist = stats.tolist()
            plan_times.append(time.perf_counter() - t0)
            iters_done = it + 1
            if safety < 1.0:
                is_collided = True
            if n_failed:
                qp_failures += int(n_failed)
                report = self.qp_violation_report(whole(prev_state),
                                                  whole(state))
                print(f"[SyncSimulator] QPFAILED at cycle {it}, agents "
                      f"{sorted(report)}; top violations: {report}")
                if p.multisim_abort_on_qp_failure:
                    print("[SyncSimulator] aborting run "
                          "(multisim_abort_on_qp_failure)")
                    break
            if log is not None:
                if self.obstacle_generator is not None:
                    log.record_cycle(
                        self, whole(state), plan_times[-1],
                        obstacles_pos=self.obstacle_generator._pos,
                        obstacles_radius=self.obstacle_generator.radii)
                else:
                    log.record_cycle(self, whole(state), plan_times[-1])
            if not p.multisim_patrol and goal_dist < p.goal_threshold:
                flight_time = iters_done * p.multisim_time_step
                break
            if p.multisim_experiment:
                # real-time pacing: the cycle's budget is one time step
                # (multi_sync_simulator.cpp:136-142)
                margin = p.multisim_time_step - plan_times[-1]
                if margin < 0:
                    print(f"[SyncSimulator] planning too slow: "
                          f"{-margin * 1e3:.1f} ms over budget")
                else:
                    time.sleep(margin)
            elif p.multisim_planning_rate > 0:
                time.sleep(1.0 / p.multisim_planning_rate)
        synchronize(self.device)
        wall = time.perf_counter() - t_wall0
        pt = np.asarray(plan_times[1:]) if len(plan_times) > 1 else \
            np.asarray(plan_times)
        return self._summarize(whole(state), pt, wall, iters_done,
                               flight_time, is_collided, profile,
                               qp_failures)

    def _run_fused(self, max_iterations, k: int, profile: bool) -> dict:
        """run() for steps_per_dispatch = k > 1 (simulator.py:1378-1420):
        blocks of k cycles a dispatch, one host read a block, the exact
        finish from the stacked per-cycle goal distances."""
        p = self.param
        max_iter = max_iterations or p.multisim_max_planner_iteration
        multi = self.make_scan_cycle(k)
        state = self.initial_state()
        t_wall0 = time.perf_counter()
        plan_times = []
        is_collided = False
        flight_time = float("nan")
        iters_done = 0
        qp_failures = 0
        for block in range((max_iter + k - 1) // k):
            t0 = time.perf_counter()
            with trace.span("run.dispatch"):
                state, (info, goal_dist, cum_dist) = multi(state)
            # one device->host read a block
            with trace.span("run.read"):
                read = torch.cat([goal_dist.double(),
                                  info.safety_step_min.double(),
                                  info.qp_failed.sum(-1).double()]).cpu()
            plan_times.append((time.perf_counter() - t0) / k)
            gd, safety, failed = read.numpy().reshape(3, k)
            qp_failures += int(failed.sum())
            done = gd < p.goal_threshold
            if not p.multisim_patrol and done.any():
                j = int(np.argmax(done))              # first finished cycle
                iters_done = block * k + j + 1
                flight_time = iters_done * p.multisim_time_step
                is_collided |= bool((safety[:j + 1] < 1.0).any())
                # truncate metrics at the finish cycle (cycles j+1..k-1
                # were planned speculatively inside the block)
                state = state._replace(distance=cum_dist[j])
                break
            iters_done = block * k + k
            is_collided |= bool((safety < 1.0).any())
        wall = time.perf_counter() - t_wall0
        # the graph's buffers: the next replay would overwrite them
        state = SwarmState(*[None if f is None else f.clone()
                             for f in state])
        pt = np.asarray(plan_times[1:]) if len(plan_times) > 1 else \
            np.asarray(plan_times)
        return self._summarize(state, pt, wall, iters_done, flight_time,
                               is_collided, profile, qp_failures)

    def _summarize(self, state, pt, wall, iters_done, flight_time,
                   is_collided, profile, qp_failures: int = 0) -> dict:
        p = self.param
        stage_times = {}
        if profile and p.planner_mode != PlannerMode.ORCA:
            stage_times = self.profile_stages(state)
        return {
            "stage_times": stage_times,
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
