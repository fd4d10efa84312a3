"""Result-CSV replay: load a recorded run and re-sample states over time
(the port's copy of lsc_planner_tpu/sim/replay.py).

Reference: MultiSyncReplayer (src/multi_sync_replayer.cpp) -- reads the
result CSV (schema inferred from the header: per-agent blocks of
id,t,px,...,size followed by per-obstacle blocks), then interpolates rows
at 50 Hz for visualization.  Here the replayer exposes the timeline as
arrays for regression checks and export; visualization is any downstream
consumer of `states_at`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

AGENT_BLOCK = 15    # columns per agent block (result CSV)
OBS_BLOCK = 6       # columns per obstacle block


@dataclasses.dataclass
class ReplayData:
    t: np.ndarray                # (T,)
    pos: np.ndarray              # (T, N, 3)
    vel: np.ndarray              # (T, N, 3)
    acc: np.ndarray              # (T, N, 3)
    planning_time: np.ndarray    # (T, N)
    qp_cost: np.ndarray          # (T, N)
    radius: np.ndarray           # (N,)
    obs_pos: Optional[np.ndarray] = None    # (T, O, 3)
    obs_radius: Optional[np.ndarray] = None  # (O,)

    @property
    def qn(self):
        return self.pos.shape[1]

    def states_at(self, t: float):
        """Linear interpolation between recorded rows
        (MultiSyncReplayer::doReplay, multi_sync_replayer.cpp:126-200)."""
        i = int(np.searchsorted(self.t, t, side="right")) - 1
        i = max(0, min(i, len(self.t) - 2))
        t0, t1 = self.t[i], self.t[i + 1]
        w = 0.0 if t1 <= t0 else np.clip((t - t0) / (t1 - t0), 0.0, 1.0)
        pos = (1 - w) * self.pos[i] + w * self.pos[i + 1]
        vel = (1 - w) * self.vel[i] + w * self.vel[i + 1]
        return pos, vel


def read_result_csv(path: str) -> ReplayData:
    """Parse a result CSV; agent/obstacle counts inferred from the header
    (readCSVFile, multi_sync_replayer.cpp:53-114)."""
    with open(path) as f:
        header = f.readline().strip().split(",")
    qn = sum(1 for c in header if c == "id")
    on = sum(1 for c in header if c == "obs_id")
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)

    T = data.shape[0]
    pos = np.zeros((T, qn, 3))
    vel = np.zeros((T, qn, 3))
    acc = np.zeros((T, qn, 3))
    ptime = np.zeros((T, qn))
    qp = np.zeros((T, qn))
    radius = np.zeros(qn)
    for qi in range(qn):
        base = qi * AGENT_BLOCK
        pos[:, qi] = data[:, base + 2: base + 5]
        vel[:, qi] = data[:, base + 5: base + 8]
        acc[:, qi] = data[:, base + 8: base + 11]
        ptime[:, qi] = data[:, base + 11]
        qp[:, qi] = data[:, base + 12]
        radius[qi] = data[0, base + 14]
    t = data[:, 1]

    obs_pos = obs_radius = None
    if on:
        obs_pos = np.zeros((T, on, 3))
        obs_radius = np.zeros(on)
        for oi in range(on):
            base = qn * AGENT_BLOCK + oi * OBS_BLOCK
            obs_pos[:, oi] = data[:, base + 2: base + 5]
            obs_radius[oi] = data[0, base + 5]

    return ReplayData(t=t, pos=pos, vel=vel, acc=acc, planning_time=ptime,
                      qp_cost=qp, radius=radius, obs_pos=obs_pos,
                      obs_radius=obs_radius)


def compare_runs(a: ReplayData, b: ReplayData) -> dict:
    """Trajectory-divergence metrics between two runs (the BASELINE
    'matched within tolerance' contract)."""
    T = min(len(a.t), len(b.t))
    dpos = np.linalg.norm(a.pos[:T] - b.pos[:T], axis=-1)
    return {
        "max_pos_err": float(dpos.max()),
        "mean_pos_err": float(dpos.mean()),
        "final_pos_err": float(dpos[-1].max()),
        "t_compared": float(a.t[T - 1]),
    }
