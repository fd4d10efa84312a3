"""Rank entry functions for ``launch.spawn_ranks``: sharded runs whose
results come back to the caller as numpy arrays and plain numbers.

Each function runs on every rank of an initialised process group, builds
its simulator and mesh there (the mission and Param arrive pickled), and
returns the same whole-swarm numbers on every rank.  They import nothing
of jax, so that a spawned rank starts with torch and the port alone.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import GoalMode, Param
from ..convert import state_to_numpy
from ..device import synchronize
from ..missions import ObstacleSpec, make_circle_mission, make_lane_mission
from ..sim.simulator import SyncSimulator, launch_counts, reset_launch_counts
from . import shard


def sequence(*calls) -> list:
    """Each (fn, args, kwargs) of `calls` in turn on this rank, in one
    process group; returns their results in order."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def _mesh(shape, device) -> shard.Mesh:
    return shard.make_mesh(device=device) if shape is None else \
        shard.make_mesh_2d(*shape, device=device)


class Resorted:
    """A cycle_fn for SyncSimulator.run: a spatial re-sort
    (shard.spatial_sort_state with `key`) before each sharded cycle.  The
    gathered states are in the sorted order."""

    def __init__(self, cycle: shard.ShardedCycle, key: str):
        self.cycle, self.key = cycle, key
        self.shard, self.gather, self.stats = \
            cycle.shard, cycle.gather, cycle.stats

    def __call__(self, state, *dyn):
        sim = self.cycle.sim
        state = shard.spatial_sort_state(
            state, sim.mission.world_min, sim.mission.world_max, self.key,
            mesh=self.cycle.mesh)
        return self.cycle(state, *dyn)


def fly_cycles(mission, param: Param, dtype=torch.float64, device=None,
               cycles: int = 3, halo_shards=None, mesh_shape=None,
               sort_key=None, keep=None) -> dict:
    """`cycles` sharded cycles of the mission from its initial state, an
    optional spatial sort (`sort_key`) before each; mesh_shape = (hosts,
    chips) for the 2-axis layout.  Returns the whole swarm's trajectories
    after the cycles in `keep` (1-based; all by default) by cycle, and per
    cycle the swarm's min safety, QPFAILED agents and max goal distance
    (one stats read a cycle, as run() does) and the host seconds of the
    cycle with that read; the final distance and safety, and this rank's
    kernel launches in the cycles (``launch_counts``)."""
    sim = SyncSimulator(mission, param, device=device, dtype=dtype)
    mesh = _mesh(mesh_shape, sim.device)
    cycle = shard.make_sharded_cycle(sim, mesh, halo_shards=halo_shards)
    step = cycle if sort_key is None else Resorted(cycle, sort_key)
    state = cycle.shard(sim.initial_state())
    keep = set(range(1, cycles + 1) if keep is None else keep)
    trajs, stats, seconds = {}, [], []
    synchronize(sim.device)
    reset_launch_counts()
    for it in range(1, cycles + 1):
        t0 = time.perf_counter()
        state, info = step(state)
        stats.append(cycle.stats(state, info).tolist())
        seconds.append(time.perf_counter() - t0)
        if it in keep:
            trajs[it] = cycle.gather(state).traj.cpu().numpy()
    launches = launch_counts()
    safety, failed, goal_dist = (np.asarray(s) for s in zip(*stats))
    return {"traj": trajs, "safety": safety, "failed": failed,
            "launches": launches,
            "goal_dist": goal_dist, "seconds": np.asarray(seconds),
            "distance": float(state.distance),
            "safety_agent_min": float(state.safety_agent_min),
            "safety_obs_min": float(state.safety_obs_min)}


def run_mission(mission, param: Param, dtype=torch.float64, device=None,
                max_iterations=None, halo_shards=None, mesh_shape=None,
                sort_key=None) -> dict:
    """SyncSimulator.run(cycle_fn=the sharded cycle) on this rank: the
    summary, its final state as numpy arrays."""
    sim = SyncSimulator(mission, param, device=device, dtype=dtype)
    mesh = _mesh(mesh_shape, sim.device)
    cycle = shard.make_sharded_cycle(sim, mesh, halo_shards=halo_shards)
    step = cycle if sort_key is None else Resorted(cycle, sort_key)
    reset_launch_counts()
    summary = sim.run(max_iterations=max_iterations, cycle_fn=step)
    summary["launches"] = launch_counts()
    summary["final_state"] = state_to_numpy(summary["final_state"])
    return summary


def profile(mission, param: Param, dtype=torch.float64, device=None,
            halo_shards=None, mesh_shape=None, n_cycles: int = 5) -> dict:
    """shard.profile_sharded of the mission on this rank's mesh."""
    sim = SyncSimulator(mission, param, device=device, dtype=dtype)
    mesh = _mesh(mesh_shape, sim.device)
    return shard.profile_sharded(sim, mesh, halo_shards=halo_shards,
                                 n_cycles=n_cycles)


# ------------------------------------------------ shard.dryrun_multichip
def _circle_sim(qn, device, dtype=torch.float32, qp_iters=14,
                max_neighbors=-1, goal_mode=GoalMode.PRIOR_BASED,
                mission=None, **param_kw) -> SyncSimulator:
    """The dry run's circle swap (the JAX package's __graft_entry__
    _make_sim): radius 4 m in a 12 x 12 x 2.5 m world."""
    if mission is None:
        mission = make_circle_mission(qn, radius=4.0,
                                      world=(-6, -6, 0, 6, 6, 2.5))
    param = Param(goal_mode=goal_mode, qp_iterations=qp_iters,
                  max_neighbors=max_neighbors, **param_kw)
    return SyncSimulator(mission, param, device=device, dtype=dtype)


def dryrun_a(device=None) -> dict:
    """(a) the all_gather cycle, K-NN pruning on, 8 agents a rank, two
    cycles: finite and safe."""
    mesh = shard.make_mesh(device=device)
    qn = 8 * mesh.size
    sim = _circle_sim(qn, mesh.device, qp_iters=6,
                      max_neighbors=min(16, qn - 1))
    cycle = shard.make_sharded_cycle(sim, mesh)
    state = cycle.shard(sim.initial_state())
    for _ in range(2):
        state, info = cycle(state)
    whole = cycle.gather(state)
    if not bool(torch.isfinite(whole.pos).all()):
        raise AssertionError("(a) non-finite positions")
    safety = float(info.safety_step_min)
    if not safety >= 1.0:
        raise AssertionError(f"(a) sharded cycle collision, {safety}")
    return {"agents": qn, "safety": safety}


def dryrun_b(device=None) -> dict:
    """(b) a full-window ring halo on the largest odd sub-mesh against the
    all_gather cycle on it (f64, exit tests off): within 1e-7 m.  The
    ranks past the sub-mesh only join its group."""
    world = torch.distributed.get_world_size()
    n_sub = world if world % 2 == 1 else world - 1
    mesh = shard.make_mesh(n_sub, device=device)
    if mesh.index is None:
        return {"ranks": n_sub, "max_diff": None}
    H = (n_sub - 1) // 2
    sim = _circle_sim(2 * n_sub, mesh.device, dtype=torch.float64,
                      qp_iters=20, qp_tol_gap=0.0, qp_tol_rp=0.0)
    full = shard.make_sharded_cycle(sim, mesh)
    halo = shard.make_sharded_cycle(sim, mesh, halo_shards=H)
    s0 = full.shard(sim.initial_state())
    ref, _ = full(s0)
    hal, _ = halo(s0)
    diff = float((full.gather(ref).traj - full.gather(hal).traj).abs().max())
    if not diff <= 1e-7:
        raise AssertionError(f"(b) full-window halo != all_gather: {diff} m")
    return {"ranks": n_sub, "max_diff": diff}


def dryrun_c(device=None) -> dict:
    """(c) the narrow halo (H = 1) with an axis:1 sort before each of 3
    cycles of a lane swarm, 2 agents a rank: finite and safe."""
    mesh = shard.make_mesh(device=device)
    mission = make_lane_mission(2 * mesh.size, lane_gap=2.0, length=6.0)
    sim = _circle_sim(None, mesh.device, qp_iters=6, max_neighbors=4,
                      mission=mission)
    step = Resorted(shard.make_sharded_cycle(sim, mesh, halo_shards=1),
                    "axis:1")
    state = step.shard(sim.initial_state())
    for _ in range(3):
        state, info = step(state)
    whole = step.gather(state)
    if not bool(torch.isfinite(whole.pos).all()):
        raise AssertionError("(c) non-finite positions")
    safety = float(info.safety_step_min)
    if not safety >= 1.0:
        raise AssertionError(f"(c) halo cycle collision, {safety}")
    return {"agents": 2 * mesh.size, "safety": safety}


def dryrun_d(device=None) -> dict:
    """(d) the 2-axis layout of 4 hosts: a cycle of the all_gather
    exchange on (a)'s swarm, and one of the host halo (H = 1) on 8 agents
    a rank: finite."""
    mesh = shard.make_mesh_2d(4, device=device)
    qn = 8 * mesh.size
    out = {}
    for name, halo, kw in (("all_gather", None,
                            dict(max_neighbors=min(16, qn - 1))),
                           ("host_halo", 1, {})):
        sim = _circle_sim(qn, mesh.device, qp_iters=6, **kw)
        cycle = shard.make_sharded_cycle(sim, mesh, halo_shards=halo)
        state, _ = cycle(cycle.shard(sim.initial_state()))
        if not bool(torch.isfinite(cycle.gather(state).pos).all()):
            raise AssertionError(f"(d) {name}: non-finite positions")
        out[name] = float(state.distance)
    return out


def dryrun_e(device=None, dtype=torch.float32) -> dict:
    """(e) the sharded body's features, 2 agents a rank: QPFAILED
    injection (a failure threshold of -1 marks every solve failed, and the
    shifted previous solution must fly, within 1e-6 m), the patrol swap of
    agents parked on their goals, and a spin obstacle (its inputs
    replicated): finite, its audit finite.  Returns the whole swarm's
    numbers."""
    mesh = shard.make_mesh(device=device)
    qn = 2 * mesh.size
    dev = mesh.device

    sim_f = _circle_sim(qn, dev, dtype=dtype, qp_iters=4,
                        qp_failure_threshold=-1.0)
    cyc_f = shard.make_sharded_cycle(sim_f, mesh)
    st_f = cyc_f.shard(sim_f.initial_state())
    st_f1, info_f = cyc_f(st_f)
    failed = shard._all_gather(info_f.qp_failed, mesh)
    if not bool(failed.all()):
        raise AssertionError("(e) QPFAILED injection did not mark agents "
                             "failed")
    whole_f = sim_f.initial_state()
    init_expect, _ = sim_f.predict_and_init(
        whole_f.traj, *sim_f.propagate(whole_f)[:2], whole_f.seq)
    traj_f = cyc_f.gather(st_f1).traj
    fallback = float((traj_f - init_expect).abs().max())
    if not fallback <= 1e-6:
        raise AssertionError("(e) QPFAILED fallback did not fly the "
                             f"shifted previous solution ({fallback} m)")

    # patrol: agents parked on their goals swap start and goal
    m_p = make_circle_mission(qn, radius=4.0, world=(-6, -6, 0, 6, 6, 2.5))
    sim_p = _circle_sim(qn, dev, dtype=dtype, qp_iters=4,
                        goal_mode=GoalMode.STATIC, mission=m_p,
                        multisim_patrol=True)
    whole_p = sim_p.initial_state()
    whole_p = whole_p._replace(
        pos=whole_p.desired_goal,
        traj=whole_p.desired_goal[:, None, None, :].expand(
            whole_p.traj.shape).clone())
    cyc_p = shard.make_sharded_cycle(sim_p, mesh)
    st_p1, _ = cyc_p(cyc_p.shard(whole_p))
    goals_p = cyc_p.gather(st_p1).desired_goal
    swap = float((goals_p - whole_p.start).abs().max())
    if not swap <= 1e-6:
        raise AssertionError(f"(e) sharded patrol swap missing ({swap} m)")

    # a dynamic obstacle through the sharded body
    m_d = dataclasses.replace(m_p, obstacles=[ObstacleSpec(
        kind="spin", size=0.3, max_acc=1.0,
        axis_position=np.array([0.0, 0.0, 1.0]),
        axis_ori=np.array([0.0, 0.0, 1.0]),
        start=np.array([1.5, 0.0, 1.0]), speed=0.5)])
    sim_d = _circle_sim(qn, dev, dtype=dtype, qp_iters=4, mission=m_d)
    if sim_d.O_dyn != 1:
        raise AssertionError(f"(e) {sim_d.O_dyn} dynamic obstacles, not 1")
    cyc_d = shard.make_sharded_cycle(sim_d, mesh)
    dp, dv = sim_d.obstacle_generator.update(0.0)
    st_d1, _ = cyc_d(cyc_d.shard(sim_d.initial_state()),
                     torch.tensor(dp, dtype=dtype, device=dev),
                     torch.tensor(dv, dtype=dtype, device=dev))
    whole_d = cyc_d.gather(st_d1)
    if not bool(torch.isfinite(whole_d.pos).all()):
        raise AssertionError("(e) dynamic obstacle: non-finite positions")
    if not np.isfinite(float(st_d1.safety_obs_min)):
        raise AssertionError("(e) dynamic obstacle: no obstacle audit")
    return {"agents": qn, "failed": failed.cpu().numpy(),
            "failed_traj": traj_f.cpu().numpy(), "fallback_err": fallback,
            "patrol_goal": goals_p.cpu().numpy(),
            "dyn_traj": whole_d.traj.cpu().numpy(),
            "dyn_safety_obs": float(st_d1.safety_obs_min)}


def dryrun_rank(device=None) -> dict:
    """The parts of shard.dryrun_multichip that this world's size admits,
    under the JAX package's conditions on its device count."""
    world = torch.distributed.get_world_size()
    out = {"a": dryrun_a(device)}
    if world >= 3:
        out["b"] = dryrun_b(device)
        out["c"] = dryrun_c(device)
    out["e"] = dryrun_e(device)
    if world >= 8 and world % 4 == 0:
        out["d"] = dryrun_d(device)
    return out
