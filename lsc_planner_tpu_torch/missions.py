"""Mission system: JSON schema loader + generators (the port's own copy of
lsc_planner_tpu/missions.py; it imports only the port's ``config``).

Keeps the reference mission JSON schema verbatim (reference
``src/mission.cpp:20-319``, ``missions/readme.txt``) so the shipped benchmark
missions can be loaded unchanged.  Also provides programmatic generators for
the benchmark corpus shapes (circle swap / square swap / random empty-world
sweeps), mirroring ``Mission::generateCircleSwap`` (mission.cpp:321-335) and
``matlab/mission_generator.m``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence

import numpy as np

from .config import Param


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

    @property
    def on(self) -> int:
        return len(self.obstacles)

    def add_noise(self, max_noise: float, dimension: int,
                  rng: Optional[np.random.Generator] = None) -> None:
        """Goal-noise fault injection (mission.cpp:386-395)."""
        if max_noise <= 0:
            return
        rng = rng or np.random.default_rng()
        for a in self.agents:
            a.goal = a.goal.copy()
            a.goal[:dimension] += rng.uniform(0, max_noise, size=dimension)

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

    def save(self, path: str) -> None:
        doc = {
            "quadrotors": {
                "crazyflie": _quad_dict(self.agents[0]) if self.agents else
                _quad_dict(AgentSpec()),
                "default": _quad_dict(AgentSpec()),
            },
            "world": [{"dimension": list(map(float, np.concatenate(
                [self.world_min, self.world_max])))}],
            "agents": [
                {"type": a.type, "cid": a.cid,
                 "start": [round(float(x), 6) for x in a.start],
                 "goal": [round(float(x), 6) for x in a.goal]}
                for a in self.agents
            ],
            "obstacles": [_obstacle_dict(o) for o in self.obstacles],
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)


def _quad_dict(a: AgentSpec) -> dict:
    return {"max_vel": list(map(float, a.max_vel)),
            "max_acc": list(map(float, a.max_acc)),
            "radius": float(a.radius),
            "nominal_velocity": float(a.nominal_velocity),
            "downwash": float(a.downwash)}


def _obstacle_dict(o: ObstacleSpec) -> dict:
    d = {"type": o.kind}
    for k in ("size", "max_acc", "downwash", "speed"):
        v = getattr(o, k)
        if v:
            d[k] = float(v)
    for k in ("axis_position", "axis_ori", "start", "goal", "initial_vel",
              "pose", "dimensions"):
        v = getattr(o, k)
        if v is not None:
            d[k] = list(map(float, v))
    if o.waypoints is not None:
        d["waypoints"] = [{"waypoint": list(map(float, w))}
                          for w in o.waypoints]
    return d


def _vec(value, z_default=None) -> np.ndarray:
    v = np.asarray([float(x) for x in value], dtype=np.float64)
    return v


def load_mission(path: str, param: Optional[Param] = None,
                 world_file_name: str = "",
                 rng: Optional[np.random.Generator] = None) -> Mission:
    """Parse a mission JSON in the reference schema (mission.cpp:20-319)."""
    param = param or Param()
    with open(path) as f:
        doc = json.load(f)

    dim = doc["world"][0]["dimension"]
    world_min = np.array(dim[0:3], dtype=np.float64)
    world_max = np.array(dim[3:6], dtype=np.float64)

    quad_map = {}
    for name, q in doc["quadrotors"].items():
        quad_map[name] = AgentSpec(
            type=name,
            radius=float(q["radius"]),
            downwash=float(q["downwash"]),
            nominal_velocity=float(q["nominal_velocity"]),
            max_vel=_vec(q["max_vel"]),
            max_acc=_vec(q["max_acc"]),
        )

    agents = []
    for qi, a in enumerate(doc["agents"]):
        spec = dataclasses.replace(quad_map[a["type"]])
        spec.id = qi
        spec.cid = int(a.get("cid", qi))
        start = _vec(a["start"])
        goal = _vec(a["goal"])
        if param.world_dimension == 2:
            start = np.array([start[0], start[1], param.world_z_2d])
            goal = np.array([goal[0], goal[1], param.world_z_2d])
        spec.start, spec.goal = start, goal
        if "radius" in a:
            spec.radius = float(a["radius"])
        if "downwash" in a:
            spec.downwash = float(a["downwash"])
        if "nominal_velocity" in a:
            spec.nominal_velocity = float(a["nominal_velocity"])
        agents.append(spec)

    obstacles = []
    for o in doc.get("obstacles", []):
        kind = o["type"]
        spec = ObstacleSpec(kind=kind,
                            size=float(o.get("size", 0.0)),
                            max_acc=float(o.get("max_acc", 0.0)),
                            downwash=float(o.get("downwash", 0.0)) or 1.0)
        if kind == "spin":
            spec.axis_position = _vec(o["axis_position"])
            spec.axis_ori = _vec(o["axis_ori"])
            spec.start = _vec(o["start"])
            spec.speed = float(o["speed"])
        elif kind == "straight":
            spec.start, spec.goal = _vec(o["start"]), _vec(o["goal"])
            spec.speed = float(o["speed"])
        elif kind == "multisim_patrol":
            spec.waypoints = np.stack(
                [_vec(w["waypoint"]) for w in o["waypoints"]])
            spec.speed = float(o["speed"])
        elif kind == "chasing":
            spec.start = _vec(o["start"])
            spec.max_vel = float(o["max_vel"])
            spec.gamma_target = float(o["gamma_target"])
            spec.gamma_obs = float(o["gamma_obs"])
        elif kind == "gaussian":
            spec.start = _vec(o["start"])
            spec.initial_vel = _vec(o["initial_vel"])
            spec.max_vel = float(o["max_vel"])
            spec.stddev_acc = float(o["stddev_acc"])
            spec.acc_update_cycle = float(o.get("acc_update_cycle", 0.0)) or 0.1
        elif kind == "static":
            spec.pose = _vec(o["pose"])
            spec.dimensions = _vec(o["dimensions"])
        elif kind == "bernstein":
            spec.traj_csv_path = o["traj_csv_path"]
            spec.traj_n = int(o["n"])
            spec.cf_id = int(o["cf_id"])
        else:
            raise ValueError(f"unknown obstacle type {kind!r}")
        obstacles.append(spec)

    m = Mission(world_min=world_min, world_max=world_max, agents=agents,
                obstacles=obstacles, mission_file_name=path,
                world_file_name=world_file_name)
    m.add_noise(param.multisim_max_noise, param.world_dimension, rng)
    return m


# ---------------------------------------------------------------------------
# Generators for the benchmark corpus (analog of matlab/mission_generator.m
# and Mission::generateCircleSwap, mission.cpp:321-335).
# ---------------------------------------------------------------------------

def _default_agent() -> AgentSpec:
    return AgentSpec()   # crazyflie-class defaults


def make_circle_mission(qn: int, radius: float = 4.0, z: float = 1.0,
                        world: Sequence[float] = (-5, -5, 0, 5, 5, 2.5),
                        ) -> Mission:
    """Circle swap: agents on a circle exchange to antipodal points."""
    agents = []
    for qi in range(qn):
        th = qi * 2 * math.pi / qn
        start = np.array([radius * math.cos(th), radius * math.sin(th), z])
        goal = np.array([-start[0], -start[1], z])
        a = _default_agent()
        a.id, a.cid = qi, qi + 1
        a.start, a.goal = start, goal
        agents.append(a)
    return Mission(world_min=np.array(world[:3], dtype=np.float64),
                   world_max=np.array(world[3:], dtype=np.float64),
                   agents=agents, mission_file_name=f"circle{qn}")


def make_square_mission(qn: int, half: float = 4.0, z: float = 1.0,
                        world: Sequence[float] = (-5, -5, 0, 5, 5, 2.5),
                        ) -> Mission:
    """Antipodal swap across a square boundary (multi_square8/16 analog)."""
    per_side = max(qn // 4, 1)
    agents = []
    for qi in range(qn):
        side = qi % 4
        k = qi // 4
        frac = (k + 1) / (per_side + 1)
        c = -half + 2 * half * frac
        pts = {0: (half, c), 1: (-c, half), 2: (-half, -c), 3: (c, -half)}
        x, y = pts[side]
        a = _default_agent()
        a.id, a.cid = qi, qi + 1
        a.start = np.array([x, y, z])
        a.goal = np.array([-x, -y, z])
        agents.append(a)
    return Mission(world_min=np.array(world[:3], dtype=np.float64),
                   world_max=np.array(world[3:], dtype=np.float64),
                   agents=agents, mission_file_name=f"square{qn}")


def make_lane_mission(qn: int, lane_gap: float = 2.0, length: float = 6.0,
                      z: float = 1.0) -> Mission:
    """Head-on pair swaps in parallel lanes: agents 2i / 2i+1 trade ends
    of lane i (y = i * lane_gap).  Interactions are confined to a lane,
    which makes this the locality benchmark for the ring-halo neighbour
    exchange (parallel/shard.py)."""
    assert qn % 2 == 0, "lane mission needs an even agent count"
    lanes = qn // 2
    agents = []
    for qi in range(qn):
        lane, side = divmod(qi, 2)
        y = lane * lane_gap
        x = (length / 2.0) * (1.0 if side == 0 else -1.0)
        a = _default_agent()
        a.id, a.cid = qi, qi + 1
        a.start = np.array([x, y, z])
        a.goal = np.array([-x, y, z])
        agents.append(a)
    m = length / 2.0 + 2.0
    return Mission(
        world_min=np.array([-m, -2.0, 0.0]),
        world_max=np.array([m, (lanes - 1) * lane_gap + 2.0, 2.5]),
        agents=agents, mission_file_name=f"lanes{qn}")


def make_random_mission(qn: int, world: Sequence[float] = (-5, -5, 0, 5, 5, 2.5),
                        z: float = 1.0, min_dist: float = 0.7,
                        seed: int = 0) -> Mission:
    """Random start/goal assignment with pairwise separation (empty-world
    sweep corpus analog, missions/empty/*)."""
    rng = np.random.default_rng(seed)
    lo = np.array(world[:3]) + 0.5
    hi = np.array(world[3:]) - 0.5

    def sample_points():
        pts = []
        trials = 0
        while len(pts) < qn:
            p = rng.uniform(lo, hi)
            p[2] = z if hi[2] - lo[2] < 1e-6 else p[2]
            if all(np.linalg.norm(p - q) > min_dist for q in pts):
                pts.append(p)
            trials += 1
            if trials > 100000:
                raise RuntimeError("cannot place agents")
        return pts

    starts, goals = sample_points(), sample_points()
    agents = []
    for qi in range(qn):
        a = _default_agent()
        a.id, a.cid = qi, qi + 1
        a.start, a.goal = starts[qi], goals[qi]
        agents.append(a)
    return Mission(world_min=np.array(world[:3], dtype=np.float64),
                   world_max=np.array(world[3:], dtype=np.float64),
                   agents=agents, mission_file_name=f"random{qn}_s{seed}")
