"""Mission data (agents, obstacles, the world box): a frozen copy of the
port's ``missions.py`` dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class AgentSpec:
    """Per-agent mission data (reference include/mission.hpp Agent)."""
    id: int = 0
    cid: int = 0
    type: str = "crazyflie"
    start: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    goal: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    radius: float = 0.15
    downwash: float = 2.0
    nominal_velocity: float = 1.0
    max_vel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3))
    max_acc: np.ndarray = dataclasses.field(
        default_factory=lambda: 2.0 * np.ones(3))


@dataclasses.dataclass
class ObstacleSpec:
    """Dynamic/static obstacle mission entry (mission.cpp:139-315).

    ``kind`` is one of spin | straight | multisim_patrol | chasing | gaussian
    | static | bernstein; the evaluation of the analytic trajectory models
    lives in ``sim/obstacles.py`` (reference include/obstacle.hpp).
    """
    kind: str
    size: float = 0.0
    max_acc: float = 0.0
    downwash: float = 1.0
    # spin
    axis_position: Optional[np.ndarray] = None
    axis_ori: Optional[np.ndarray] = None
    # spin/straight/chasing/gaussian
    start: Optional[np.ndarray] = None
    goal: Optional[np.ndarray] = None
    speed: float = 0.0
    # patrol
    waypoints: Optional[np.ndarray] = None
    # chasing
    max_vel: float = 0.0
    gamma_target: float = 0.0
    gamma_obs: float = 0.0
    # gaussian
    initial_vel: Optional[np.ndarray] = None
    stddev_acc: float = 0.0
    acc_update_cycle: float = 0.1
    # static
    pose: Optional[np.ndarray] = None
    dimensions: Optional[np.ndarray] = None
    # bernstein
    traj_csv_path: str = ""
    traj_n: int = 5
    cf_id: int = -1


@dataclasses.dataclass
class Mission:
    """World bbox + agents + obstacles (reference include/mission.hpp)."""
    world_min: np.ndarray
    world_max: np.ndarray
    agents: List[AgentSpec]
    obstacles: List[ObstacleSpec] = dataclasses.field(default_factory=list)
    mission_file_name: str = ""
    world_file_name: str = ""

    @property
    def qn(self) -> int:
        return len(self.agents)

    # ---- batched array views (N-padded, planner-facing) ----
    def agent_arrays(self) -> dict:
        N = self.qn
        return {
            "start": np.stack([a.start for a in self.agents]).astype(np.float64),
            "goal": np.stack([a.goal for a in self.agents]).astype(np.float64),
            "radius": np.array([a.radius for a in self.agents]),
            "downwash": np.array([a.downwash for a in self.agents]),
            "nominal_velocity": np.array(
                [a.nominal_velocity for a in self.agents]),
            "max_vel": np.stack([a.max_vel for a in self.agents]),
            "max_acc": np.stack([a.max_acc for a in self.agents]),
            "id": np.arange(N),
        }


# ---------------------------------------------------------------------------
# Generators for the benchmark corpus (analog of matlab/mission_generator.m
# and Mission::generateCircleSwap, mission.cpp:321-335).
# ---------------------------------------------------------------------------


