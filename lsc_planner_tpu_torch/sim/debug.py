"""Constraint-construction debugger: per-agent, per-cycle artifact dumps
(the port's copy of lsc_planner_tpu/sim/debug.py; tensors are read back
to numpy).

Reference: the offline debugger node (include/dynamic_debugger.hpp +
src/multi_sync_debugger_node.cpp) replays a rosbag of raw topics for one
agent/sequence and animates LSC construction and trajectory optimization
in rviz.  Here the same artifacts -- initial trajectories, predicted
obstacle trajectories, LSC normals/d values, SFC boxes, the solved
trajectory, and QP diagnostics -- are captured per cycle as arrays and
dumped to a .npz for offline inspection or plotting.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class DebugRecorder:
    """Attachable per-cycle artifact recorder.

    Usage:
        dbg = DebugRecorder(out_dir, agent_id=3)
        dbg.record(...)            # from a custom loop, each cycle
        dbg.save()
    """
    out_dir: str
    agent_id: Optional[int] = None     # None = all agents
    _frames: List[dict] = dataclasses.field(default_factory=list)

    def record(self, seq: int, init_traj, obs_pred, normals, rhs, traj,
               qp_cost, primal_res, sfc=None, current_goal=None):
        sel = slice(None) if self.agent_id is None else \
            slice(self.agent_id, self.agent_id + 1)
        frame = {
            "seq": int(seq),
            "init_traj": _np(init_traj)[sel],
            "obs_pred": _np(obs_pred)[sel],
            "lsc_normal": _np(normals)[sel],
            "lsc_rhs": _np(rhs)[sel],
            "traj": _np(traj)[sel],
            "qp_cost": _np(qp_cost)[sel],
            "primal_res": _np(primal_res)[sel],
        }
        if sfc is not None:
            frame["sfc"] = _np(sfc)[sel]
        if current_goal is not None:
            frame["current_goal"] = _np(current_goal)[sel]
        self._frames.append(frame)

    def save(self, name: str = "debug_dump") -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"{name}.npz")
        flat = {}
        for i, fr in enumerate(self._frames):
            for k, v in fr.items():
                flat[f"f{i:05d}_{k}"] = v
        np.savez_compressed(path, **flat)
        return path

    @staticmethod
    def load(path: str) -> List[dict]:
        data = np.load(path)
        frames: dict = {}
        for key in data.files:
            fid, _, name = key.partition("_")
            frames.setdefault(int(fid[1:]), {})[name] = data[key]
        return [frames[k] for k in sorted(frames)]

    def check_lsc_feasibility(self, frame_idx: int = -1) -> dict:
        """The QPFAILED diagnosis analog (traj_planner.cpp:1556-1577):
        check every recorded LSC against the initial trajectory and report
        violated rows."""
        fr = self._frames[frame_idx]
        init = fr["init_traj"]               # (A, M, n+1, 3)
        normal = fr["lsc_normal"]            # (A, C, M, 3)
        rhs = fr["lsc_rhs"]                  # (A, C, M, n+1)
        margin = np.einsum("acmk,amik->acmi", normal, init) - rhs
        bad = np.argwhere(margin < 0)
        return {"violations": bad, "worst": float(margin.min())}
