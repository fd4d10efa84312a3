"""Result and summary CSV logging in the reference's schema (port of
lsc_planner_tpu/sim/logging.py).

Reference: MultiSyncSimulator::savePlanningResultAsCSV
(src/multi_sync_simulator.cpp:513-587) and saveSummarizedResultAsCSV
(:589-633).  The exact column layout keeps runs replayable by the
reference's tooling (sim/replay.py reads it back) and comparable row by
row with the JAX package's logs.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Param
from ..ops import bernstein as bz


RESULT_AGENT_COLS = ("id,t,px,py,pz,vx,vy,vz,ax,ay,az,planning_time,"
                     "qp_cost,planning_report,size")
RESULT_OBS_COLS = "obs_id,t,px,py,pz,size"
SUMMARY_HEADER = (
    "start_time,total_flight_time,total_flight_distance,is_collided,"
    "safety_ratio_agent,average_planning_time,min_planning_time,"
    "max_planning_time,initial_traj_planning_time,obstacle_prediction_time,"
    "goal_planning_time,lsc_generation_time,sfc_generation_time,"
    "traj_optimization_time,mission_file_name,world_file_name,planner_mode,"
    "prediction_mode,initial_traj_mode,slack_mode,goal_mode,"
    "world_dimension,dt,horizon,N_constraint_segments")


@dataclasses.dataclass
class ResultLogger:
    """Streams the per-cycle full state history CSV
    (result_<stamp>_<mode>_<N>agents.csv)."""
    log_dir: str
    param: Param
    qn: int
    on: int = 0

    def __post_init__(self):
        os.makedirs(self.log_dir, exist_ok=True)
        self.start_time = time.time()
        p = self.param
        name = (f"result_{self.start_time:.6f}_"
                f"{p.planner_mode_str()}_{self.qn}agents.csv")
        self.path = os.path.join(self.log_dir, name)
        self._t = 0.0
        self._wrote_header = False

    def _header(self):
        cols = [RESULT_AGENT_COLS] * self.qn + [RESULT_OBS_COLS] * self.on
        return ",".join(cols) + "\n"

    def record_cycle(self, sim, state, planning_time: float,
                     obstacles_pos: Optional[np.ndarray] = None,
                     obstacles_radius: Optional[np.ndarray] = None):
        """Sample the new solutions over the upcoming time step at the
        record resolution (float64 on the CPU, one read of the state a
        cycle) and append the CSV rows."""
        p = self.param
        traj = state.traj.detach().to("cpu", torch.float64)
        qp_cost = state.qp_cost.detach().cpu().double().numpy()
        radius = sim.radius.detach().cpu().double().numpy()
        rows = []
        ft = 0.0
        while ft < p.multisim_time_step:
            st = bz.traj_state_batch(traj, ft, p.dt)
            pos, vel, acc = (st[k].numpy() for k in ("pos", "vel", "acc"))
            cells = []
            for qi in range(self.qn):
                cells.append(
                    f"{qi},{self._t:.6g},"
                    f"{pos[qi, 0]:.6g},{pos[qi, 1]:.6g},{pos[qi, 2]:.6g},"
                    f"{vel[qi, 0]:.6g},{vel[qi, 1]:.6g},{vel[qi, 2]:.6g},"
                    f"{acc[qi, 0]:.6g},{acc[qi, 1]:.6g},{acc[qi, 2]:.6g},"
                    f"{planning_time:.6g},{qp_cost[qi]:.6g},1,"
                    f"{radius[qi]:.6g}")
            for oi in range(self.on):
                op = obstacles_pos[oi] if obstacles_pos is not None else \
                    np.zeros(3)
                orad = obstacles_radius[oi] if obstacles_radius is not None \
                    else 0.0
                cells.append(f"{oi},{self._t:.6g},"
                             f"{op[0]:.6g},{op[1]:.6g},{op[2]:.6g},"
                             f"{orad:.6g}")
            rows.append(",".join(cells) + "\n")
            ft += p.multisim_record_time_step
            self._t += p.multisim_record_time_step
        with open(self.path, "a") as f:
            if not self._wrote_header:
                f.write(self._header())
                self._wrote_header = True
            f.writelines(rows)


def append_summary(log_dir: str, param: Param, qn: int, summary: dict,
                   mission_file: str = "", world_file: str = "") -> str:
    """Append one summary row (summary_<mode>_<N>agents.csv)."""
    os.makedirs(log_dir, exist_ok=True)
    p = param
    path = os.path.join(log_dir,
                        f"summary_{p.planner_mode_str()}_{qn}agents.csv")
    need_header = not os.path.exists(path) or os.path.getsize(path) == 0
    stage = summary.get("stage_times", {})
    row = ",".join(str(x) for x in (
        time.time(),
        summary.get("total_flight_time"),
        summary.get("total_flight_distance"),
        int(summary.get("is_collided", False)),
        summary.get("safety_ratio_agent"),
        summary.get("average_planning_time"),
        summary.get("min_planning_time"),
        summary.get("max_planning_time"),
        stage.get("initial_traj", 0.0),
        stage.get("obstacle_prediction", 0.0),
        stage.get("goal_planning", 0.0),
        stage.get("lsc_generation", 0.0),
        stage.get("sfc_generation", 0.0),
        stage.get("traj_optimization", 0.0),
        mission_file, world_file,
        p.planner_mode_str(),
        p.prediction_mode.value, p.initial_traj_mode.value,
        p.slack_mode.value, p.goal_mode.value,
        p.world_dimension, p.dt, p.horizon, p.n_constraint_segments,
    )) + "\n"
    with open(path, "a") as f:
        if need_header:
            f.write(SUMMARY_HEADER + "\n")
        f.write(row)
    return path
