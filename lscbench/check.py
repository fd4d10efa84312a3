"""Whether the timed path planned correctly: the plain reference the
cell's configuration names (``reference/<name>/``, ``lsc`` by default;
plain PyTorch, float64) judges the dispatches a run keeps.

A graph replay exposes the swarm state only between dispatches, so the
reference follows the program step by step from the program's own state:
for each kept dispatch it takes the state the replay started from and
plans the same k cycles itself, and it judges the state the replay
ended in by what a planned trajectory has to satisfy.  The start of the
chain, the initial state, is checked by itself (dispatch 0 is always
kept).  The numbers below are compared where the cell's
``workloads/<cell>.json`` gives a limit (the exact ones and the
configuration's guarantees always); the others are printed beside them as
figures:

- ``initial_state_diff``: elements of the program's initial state that
  differ from the reference's own, cast to the program's dtype (exact: 0);
- ``seq_diff``: cycles the replay advanced the planner's sequence number,
  less k (exact: 0);
- ``pos_gap_p50_m``, ``pos_gap_p90_m``: the median and the 90th
  percentile over agents of the distance between the program's positions
  after k cycles and the reference's;
- ``vel_gap_p50_mps``, ``vel_gap_p90_mps``: the median and the 90th
  percentile over agents of the same distance between velocities;
- ``far_agents_share``: the share of agents whose position after k cycles
  lies farther from the reference's than half the distance the reference
  moved them (at least 0.1 m): agents planned elsewhere;
- ``start_gap_m``: the largest distance between a final trajectory's first
  three control points and those its start state (position, velocity,
  acceleration) fixes;
- ``audit_gap``: the program's safety ratio of its last cycle against the
  reference's audit of the same trajectories, as a share;
- ``dyn_excess_over_ref``: the configuration's dynamic limits, in the
  agent's units: how far any velocity or acceleration control point of a
  final trajectory exceeds the agent's max_vel or max_acc, as a share of
  the limit (``dyn_excess``, printed), less the same reading of the
  reference's own final trajectories from the same start state
  (``ref_dyn_excess``, printed; taken as 0 where within the limits), the
  largest over the kept dispatches: the program may exceed the limits no
  further than the planner's float64 solve does;
- ``sfc_excess_m`` (worlds with obstacles): how far any control point lies
  outside its segment's SFC box;
- ``agent_safety_min``, ``obstacle_safety_min``: the configuration's
  guarantees, over the window's reports and the reference's audits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import cell as cell_mod


class Kept(NamedTuple):
    d: int          # dispatch index in the window
    pre: tuple      # the program's state the replay started from
    post: tuple     # the program's state the replay ended in
    info: tuple     # the replay's stacked CycleInfo (k, ...)


def kept_dispatches(spec: dict, seed: int) -> set:
    """Dispatch 0 and spec["count"] - 1 others drawn from the seed in
    [spec["from"][0], spec["from"][1])."""
    lo, hi = spec["from"]
    rng = np.random.default_rng([seed, 0x6c7363])
    rest = rng.choice(np.arange(lo, hi), size=int(spec["count"]) - 1,
                      replace=False)
    return {0, *(int(i) for i in rest)}


def holds(value, limit, kind) -> bool:
    if value is None:
        return False
    if kind == "at_most":
        return value <= limit
    if kind == "at_least":
        return value >= limit
    raise ValueError(kind)


def reference_modules(c):
    """The config, missions, sim.simulator and sim.audit modules of the
    plain reference cell c's configuration names (``Cell.reference``)."""
    return tuple(c.reference(m) for m in ("config", "missions",
                                          "sim.simulator", "sim.audit"))


def _as(state_cls, state, dtype, device):
    """A state in the reference's SwarmState, floats cast to dtype."""
    return state_cls(*[None if f is None else
                       (f.to(device=device, dtype=dtype)
                        if f.is_floating_point() else f.to(device))
                       for f in state])


def start_points(pos, vel, acc, dt, n):
    """The first three Bernstein control points a segment of duration dt
    and degree n starting at (pos, vel, acc) has: (N, 3, 3)."""
    x1 = pos + vel * (dt / n)
    x2 = pos + vel * (2 * dt / n) + acc * (dt * dt / (n * (n - 1)))
    return torch.stack([pos, x1, x2], dim=1)


def dyn_excess(traj, max_vel, max_acc, dt):
    """The largest |velocity| / max_vel or |acceleration| / max_acc over
    the Bernstein derivative control points of traj (N, M, n+1, 3), less
    one (<= 0 within the limits)."""
    n = traj.shape[2] - 1
    v = (traj[:, :, 1:] - traj[:, :, :-1]) * (n / dt)
    a = (v[:, :, 1:] - v[:, :, :-1]) * ((n - 1) / dt)
    rv = (v.abs() / max_vel[:, None, None, :]).amax()
    ra = (a.abs() / max_acc[:, None, None, :]).amax()
    return float(torch.maximum(rv, ra)) - 1.0


def sfc_excess(traj, sfc, planned):
    """How far any control point of segment m lies outside box m, over
    the agents whose QP did not fail (`planned`; a QPFAILED agent flies
    its previous plan, which no box holds): traj (N, M, n+1, 3), sfc (N,
    M, 6) as [min, max]."""
    lo, hi = sfc[:, :, None, :3], sfc[:, :, None, 3:]
    out = torch.maximum(lo - traj, traj - hi).clamp(min=0.0)
    return float(out[planned].amax()) if bool(planned.any()) else 0.0


def judge(c, arrays: dict, keeps: list, window_safety_min: float,
          device) -> dict:
    """({name: (value, limit, "at_most" | "at_least")} of the numbers the
    module docstring lists that the cell's limits name, over `keeps`;
    {name: value} of figures printed beside them and not compared).  The
    reference runs in float64 on `device`, in the run's process, after the
    program's state is freed."""
    rconfig, rmissions, rsim_mod, raudit = reference_modules(c)
    limits = c.workload["limits"]
    guarantees = c.config["guarantees"]
    param = cell_mod.build_param(rconfig, c.config)
    mission = cell_mod.build_mission(rmissions, arrays, c.config["agent"])
    f64 = torch.float64
    rsim = rsim_mod.SyncSimulator(mission, param, device=device, dtype=f64)
    p, k = rsim.param, c.k
    State = rsim_mod.SwarmState

    init_diff = None
    stats = {}
    pos_gap = pos_mid = start_gap = audit_gap = sfc = far = 0.0
    dyn = -float("inf")
    vel_gap = vel_mid = 0.0
    seq_diff = 0
    safety = [window_safety_min]
    obs_safety = []
    for kept in keeps:
        if kept.d == 0:
            ref0 = rsim.initial_state()
            init_diff = 0
            for a, b in zip(kept.pre, ref0):
                if a is None or b is None:
                    continue
                b = b.to(device=a.device, dtype=a.dtype)
                init_diff += int((a != b).sum())
        s = _as(State, kept.pre, f64, device)
        for _ in range(k):
            s, rinfo = rsim.cycle(s)
            stats["ref_qp_failed"] = stats.get("ref_qp_failed", 0) + int(
                rinfo.qp_failed.sum())
        stats["prog_qp_failed"] = stats.get("prog_qp_failed", 0) + int(
            kept.info.qp_failed.sum())
        post = _as(State, kept.post, f64, device)
        seq_diff = max(seq_diff, abs(int(post.seq) - int(kept.pre.seq) - k))
        gap = torch.linalg.vector_norm(post.pos - s.pos, dim=-1)
        pos_gap = max(pos_gap, float(torch.quantile(gap, 0.9)))
        pos_mid = max(pos_mid, float(torch.quantile(gap, 0.5)))
        moved = torch.linalg.vector_norm(s.pos - kept.pre.pos.to(
            device=device, dtype=f64), dim=-1)
        for q, v in (("pos_gap_mean_m", gap.mean()),
                     ("moved_p50_m", torch.quantile(moved, 0.5))):
            stats[q] = max(stats.get(q, 0.0), float(v))
        want = start_points(post.pos, post.vel, post.acc, p.dt, p.n)
        start_gap = max(start_gap, float(torch.linalg.vector_norm(
            post.traj[:, 0, :3, :] - want, dim=-1).amax()))
        ratio = float(raudit.step_safety_ratio(
            post.traj, rsim.radius, rsim.downwash, p.dt,
            p.multisim_record_time_step, p.multisim_time_step))
        safety.append(ratio)
        prog_ratio = float(kept.info.safety_step_min[-1])
        audit_gap = max(audit_gap, abs(prog_ratio - ratio) / abs(ratio))
        # the program's final plans against the limits, beside the
        # reference's own final plans from the same start state (the
        # witness: the planner's f64 solve holds the limits no closer)
        prog_dyn = dyn_excess(post.traj, rsim.max_vel, rsim.max_acc, p.dt)
        ref_dyn = dyn_excess(s.traj, rsim.max_vel, rsim.max_acc, p.dt)
        dyn = max(dyn, prog_dyn - max(ref_dyn, 0.0))
        for q, v in (("dyn_excess", prog_dyn), ("ref_dyn_excess", ref_dyn)):
            stats[q] = max(stats.get(q, -1.0), v)
        vgap = torch.linalg.vector_norm(post.vel - s.vel, dim=-1)
        vel_gap = max(vel_gap, float(torch.quantile(vgap, 0.9)))
        vel_mid = max(vel_mid, float(torch.quantile(vgap, 0.5)))
        planned = ~kept.info.qp_failed[-1].to(device)
        far = max(far, float((gap > 0.5 * moved.clamp(min=0.2)).double()
                             .mean()))
        if rsim.static_boxes.shape[0]:
            sfc = max(sfc, sfc_excess(post.traj, post.sfc, planned))
            obs_safety.append(float(raudit.static_box_safety_ratio(
                post.pos, rsim.static_boxes, rsim.radius)))
            obs_safety.append(float(post.safety_obs_min))
    del rsim
    out = {}
    if init_diff is not None:
        out["initial_state_diff"] = (init_diff, 0, "at_most")
    out["seq_diff"] = (seq_diff, 0, "at_most")
    for name, value in (("pos_gap_p50_m", pos_mid),
                        ("pos_gap_p90_m", pos_gap),
                        ("far_agents_share", far),
                        ("vel_gap_p50_mps", vel_mid),
                        ("vel_gap_p90_mps", vel_gap),
                        ("start_gap_m", start_gap),
                        ("audit_gap", audit_gap),
                        ("dyn_excess_over_ref", dyn),
                        ("sfc_excess_m", sfc)):
        if name in limits:
            out[name] = (value, limits[name], "at_most")
        else:
            stats[name] = value
    out["agent_safety_min"] = (min(safety),
                               guarantees["agent_safety_ratio_min"],
                               "at_least")
    if obs_safety:
        out["obstacle_safety_min"] = (
            min(obs_safety), guarantees["obstacle_safety_ratio_min"],
            "at_least")
    return out, stats
