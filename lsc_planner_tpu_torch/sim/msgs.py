"""Typed message schema: the ``dynamic_msgs`` ROS package analog
(the port's copy of lsc_planner_tpu/sim/msgs.py).

The reference exchanges all cross-process data as ROS messages from the
out-of-repo ``dynamic_msgs`` package (SURVEY.md component 26; field sets
reconstructed from their use sites: State/FullState in
multi_sync_simulator.cpp:196-246 and cmd_publisher.cpp:73-127, Obstacle in
obstacle_generator.hpp:120-142, Trajectory in util.hpp:106-148,
CollisionConstraint export in collision_constraints.cpp:496-537).

Here the swarm state lives on-device and never needs serialization inside
a cycle; these dataclasses are the HOST-side wire format -- JSON-friendly
dicts for logging, the debugger, the command bridge, and any external
consumer replacing rviz/ROS.  Every type round-trips through
``to_dict``/``from_dict`` and carries the same information content as its
ROS counterpart.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np


def _vec(x) -> List[float]:
    return [float(v) for v in np.asarray(x).reshape(-1)]


@dataclasses.dataclass
class State:
    """dynamic_msgs/State: pose + derivatives + planner sequence."""
    id: int
    planner_seq: int
    pos: List[float]
    vel: List[float]
    acc: List[float]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "State":
        return cls(**d)


@dataclasses.dataclass
class FullState:
    """dynamic_msgs/FullState: the 50 Hz hardware command
    (cmd_publisher.cpp:73-127) -- flat outputs + yaw + body rates."""
    id: int
    t: float
    pos: List[float]
    vel: List[float]
    acc: List[float]
    yaw: float = 0.0
    omega: Optional[List[float]] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FullState":
        return cls(**d)


@dataclasses.dataclass
class Obstacle:
    """dynamic_msgs/Obstacle (obstacle_generator.hpp:120-142)."""
    id: int
    type: str                      # "agent" | "spin" | ... | "static"
    pos: List[float]
    vel: List[float]
    goal_point: List[float]
    radius: float
    max_acc: float = 0.0
    downwash: float = 1.0
    dimensions: Optional[List[float]] = None    # static AABB half-extents

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Obstacle":
        return cls(**d)


@dataclasses.dataclass
class ObstacleArray:
    start_time: float
    obstacles: List[Obstacle]

    def to_dict(self) -> dict:
        return {"start_time": self.start_time,
                "obstacles": [o.to_dict() for o in self.obstacles]}

    @classmethod
    def from_dict(cls, d: dict) -> "ObstacleArray":
        return cls(start_time=d["start_time"],
                   obstacles=[Obstacle.from_dict(o)
                              for o in d["obstacles"]])


@dataclasses.dataclass
class Trajectory:
    """dynamic_msgs/Trajectory (util.hpp:106-148): M segments of degree-n
    Bernstein control points with segment time dt."""
    id: int
    M: int
    n: int
    dt: float
    control_points: List[List[float]]   # (M*(n+1), 3) row-major

    @classmethod
    def from_array(cls, traj_id: int, ctrl: np.ndarray,
                   dt: float) -> "Trajectory":
        ctrl = np.asarray(ctrl)          # (M, n+1, 3)
        M, n1, _ = ctrl.shape
        return cls(id=traj_id, M=M, n=n1 - 1, dt=float(dt),
                   control_points=[_vec(p) for p in
                                   ctrl.reshape(M * n1, 3)])

    def to_array(self) -> np.ndarray:
        return np.asarray(self.control_points,
                          np.float64).reshape(self.M, self.n + 1, 3)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Trajectory":
        return cls(**d)


@dataclasses.dataclass
class TrajectoryArray:
    planner_seq: int
    trajectories: List[Trajectory]

    @classmethod
    def from_swarm(cls, seq: int, trajs: np.ndarray,
                   dt: float) -> "TrajectoryArray":
        return cls(planner_seq=int(seq),
                   trajectories=[Trajectory.from_array(i, t, dt)
                                 for i, t in enumerate(np.asarray(trajs))])

    def to_array(self) -> np.ndarray:
        return np.stack([t.to_array() for t in self.trajectories])

    def to_dict(self) -> dict:
        return {"planner_seq": self.planner_seq,
                "trajectories": [t.to_dict() for t in self.trajectories]}

    @classmethod
    def from_dict(cls, d: dict) -> "TrajectoryArray":
        return cls(planner_seq=d["planner_seq"],
                   trajectories=[Trajectory.from_dict(t)
                                 for t in d["trajectories"]])


@dataclasses.dataclass
class CollisionConstraint:
    """dynamic_msgs/CollisionConstraint
    (collision_constraints.cpp:496-537): per (obstacle, segment) LSC
    planes -- obstacle control points, normal, d values per control
    point -- plus the SFC box corridor."""
    planner_seq: int
    agent_id: int
    # rsfcs[c][m]: {"obs_control_points": (n+1,3), "normal_vector": (3,),
    #              "d": (n+1,)}
    rsfcs: List[List[dict]]
    # sfcs[m]: {"box_min": (3,), "box_max": (3,)}
    sfcs: List[dict]

    @classmethod
    def from_planes(cls, seq: int, agent_id: int, obs_pred: np.ndarray,
                    normal: np.ndarray, d: np.ndarray,
                    boxes: Optional[np.ndarray]) -> "CollisionConstraint":
        """obs_pred (C, M, n+1, 3), normal (C, M, 3), d (C, M, n+1),
        boxes (M, 6) or None."""
        C, M = normal.shape[:2]
        rsfcs = [[{"obs_control_points":
                   [_vec(p) for p in np.asarray(obs_pred[c, m])],
                   "normal_vector": _vec(normal[c, m]),
                   "d": _vec(d[c, m])}
                  for m in range(M)] for c in range(C)]
        sfcs = []
        if boxes is not None:
            sfcs = [{"box_min": _vec(boxes[m, :3]),
                     "box_max": _vec(boxes[m, 3:])}
                    for m in range(np.asarray(boxes).shape[0])]
        return cls(planner_seq=int(seq), agent_id=int(agent_id),
                   rsfcs=rsfcs, sfcs=sfcs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CollisionConstraint":
        return cls(**d)


@dataclasses.dataclass
class Goal:
    """dynamic_msgs/Goal (goalPlanning output per agent)."""
    id: int
    planner_seq: int
    current_goal: List[float]
    desired_goal: List[float]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Goal":
        return cls(**d)


def dump_json(msg, path: str) -> None:
    with open(path, "w") as f:
        json.dump(msg.to_dict(), f)


def load_json(cls, path: str):
    with open(path) as f:
        return cls.from_dict(json.load(f))
