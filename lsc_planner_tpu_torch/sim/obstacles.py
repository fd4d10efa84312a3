"""Dynamic-obstacle trajectory models + obstacle generator (the port's own
copy of lsc_planner_tpu/sim/obstacles.py; numpy on the host).

Reference: the analytic obstacle models of ``include/obstacle.hpp`` (spin,
straight, patrol, chasing, gaussian, static, bernstein) and the
ObstacleGenerator (``include/obstacle_generator.hpp``) that evaluates all
mission obstacles at t, injects Gaussian observation noise, and feeds each
agent its ObstacleArray.

Design: each model is a pure function state(t) -> (pos, vel); stateful
models (chasing, gaussian) pre-sample their randomness so evaluation stays
pure/replayable.  Batched evaluation returns (O, 3) tensors for the
planning cycle.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from ..config import SP_EPSILON_FLOAT
from ..missions import Mission, ObstacleSpec
from ..ops.bernstein import nchoosek


class ObstacleModel:
    """Base: state(t) -> (pos (3,), vel (3,)) in numpy (host-side; obstacle
    counts are small and models are scalar recurrences)."""
    spec: ObstacleSpec

    def state(self, t: float):
        raise NotImplementedError

    @property
    def radius(self):
        return self.spec.size

    @property
    def is_static(self):
        return False


@dataclasses.dataclass
class SpinObstacle(ObstacleModel):
    """Circular motion about an axis (obstacle.hpp:68-121)."""
    spec: ObstacleSpec

    def __post_init__(self):
        axis_pos = np.asarray(self.spec.axis_position, float)
        n = np.asarray(self.spec.axis_ori, float)
        self.n = n / np.linalg.norm(n)
        self.a = np.asarray(self.spec.start, float) - axis_pos
        self.axis_pos = axis_pos
        r = self.a - self.a.dot(self.n) * self.n
        self.spin_radius = np.linalg.norm(r)
        self.w = self.spec.speed / self.spin_radius

    def _rotate(self, v, theta):
        n = self.n
        # Rodrigues
        return (v * math.cos(theta) + np.cross(n, v) * math.sin(theta)
                + n * n.dot(v) * (1 - math.cos(theta)))

    def state(self, t: float):
        theta = self.w * t
        p = self._rotate(self.a, theta)
        pos = self.axis_pos + p
        vel = self.w * self._rotate(p, math.pi / 2)
        return pos, vel


@dataclasses.dataclass
class StraightObstacle(ObstacleModel):
    """Constant-velocity start->goal then stop (obstacle.hpp:123-173)."""
    spec: ObstacleSpec

    def __post_init__(self):
        self.start = np.asarray(self.spec.start, float)
        self.goal = np.asarray(self.spec.goal, float)
        delta = self.goal - self.start
        dist = np.linalg.norm(delta)
        self.v = self.spec.speed * (delta / dist) if dist > 0 else \
            np.zeros(3)
        self.flight_time = dist / self.spec.speed if self.spec.speed > 0 \
            else np.inf

    def state(self, t: float):
        if t < self.flight_time:
            return self.start + self.v * t, self.v.copy()
        return self.goal.copy(), np.zeros(3)


@dataclasses.dataclass
class PatrolObstacle(ObstacleModel):
    """Cyclic waypoint patrol of straight legs (obstacle.hpp:175-231)."""
    spec: ObstacleSpec

    def __post_init__(self):
        wps = np.asarray(self.spec.waypoints, float)
        self.legs = []
        for i in range(len(wps)):
            j = (i + 1) % len(wps)
            leg_spec = dataclasses.replace(
                self.spec, kind="straight", start=wps[i], goal=wps[j])
            self.legs.append(StraightObstacle(leg_spec))

    def state(self, t: float):
        i = 0
        while t >= self.legs[i].flight_time:
            t -= self.legs[i].flight_time
            i = (i + 1) % len(self.legs)
        return self.legs[i].state(t)


@dataclasses.dataclass
class ChasingObstacle(ObstacleModel):
    """Potential-field pursuer (obstacle.hpp:234-328): attracted to a goal
    point, repulsed from nearby obstacles; integrates between calls.
    Stateful like the reference -- call order with increasing t."""
    spec: ObstacleSpec

    def __post_init__(self):
        self.pos = np.asarray(self.spec.start, float).copy()
        self.vel = np.zeros(3)
        self.goal_point = self.pos.copy()
        self.obstacles: List = []       # (pos, radius) tuples
        self.t_last = 0.0

    def set_goal_point(self, goal):
        self.goal_point = np.asarray(goal, float)

    def set_obstacles(self, obstacles):
        self.obstacles = obstacles

    def state(self, t: float):
        dt = t - self.t_last
        a = self.spec.gamma_target * (self.goal_point - self.pos)
        for (opos, orad) in self.obstacles:
            delta = np.asarray(opos) - self.pos
            dist = np.linalg.norm(delta)
            if dist < SP_EPSILON_FLOAT:
                continue
            q_star = 2 * (self.spec.size + orad)
            if dist < q_star:
                a += (self.spec.gamma_obs * (1 - dist / q_star)
                      * (1 / (dist * q_star)) * (-delta / dist))
        max_acc = self.spec.max_acc - 0.01
        if np.linalg.norm(a) > max_acc:
            a = a / np.linalg.norm(a) * max_acc
        v = self.vel + a * dt
        if np.linalg.norm(v) > self.spec.max_vel:
            v = v / np.linalg.norm(v) * self.spec.max_vel
        self.pos = self.pos + v * dt
        self.vel = v
        self.t_last = t
        return self.pos.copy(), self.vel.copy()


@dataclasses.dataclass
class GaussianObstacle(ObstacleModel):
    """Random-walk acceleration model (obstacle.hpp:330-435): piecewise-
    constant gaussian accelerations re-sampled every acc_update_cycle,
    velocity-capped; the acceleration history is pre-sampled so state(t)
    is a pure replayable function."""
    spec: ObstacleSpec
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.acc_history: List[np.ndarray] = []
        self.horizon = 0.0
        self._extend(10.0)

    def _extend(self, desired):
        while self.horizon < desired:
            acc = self.rng.normal(0.0, self.spec.stddev_acc, size=3)
            if np.linalg.norm(acc) > self.spec.max_acc:
                acc = acc / np.linalg.norm(acc) * self.spec.max_acc
            self.acc_history.append(acc)
            self.horizon += self.spec.acc_update_cycle
        return None

    def state(self, t: float):
        if t >= self.horizon:
            self._extend(self.horizon + 10.0)
        cyc = self.spec.acc_update_cycle
        n = int(math.floor((t + SP_EPSILON_FLOAT) / cyc))
        pos = np.asarray(self.spec.start, float).copy()
        vel = np.asarray(self.spec.initial_vel, float).copy()
        v = vel.copy()
        for i in range(n + 1):
            dt = cyc if i < n else (t - n * cyc)
            acc = self.acc_history[i]
            v_next = v + acc * dt
            if np.linalg.norm(v_next) > self.spec.max_vel:
                pos += v * dt
            else:
                pos += v * dt + 0.5 * acc * dt * dt
                vel += acc * dt
                v = v_next
        return pos, vel


@dataclasses.dataclass
class StaticObstacle(ObstacleModel):
    """Axis-aligned box obstacle (obstacle.hpp:437-478)."""
    spec: ObstacleSpec

    def state(self, t: float):
        return np.asarray(self.spec.pose, float).copy(), np.zeros(3)

    @property
    def is_static(self):
        return True

    @property
    def dimensions(self):
        return np.asarray(self.spec.dimensions, float)


@dataclasses.dataclass
class BernsteinObstacle(ObstacleModel):
    """Pre-recorded piecewise Bernstein trajectory from CSV
    (obstacle.hpp:480-515)."""
    spec: ObstacleSpec

    def __post_init__(self):
        rows = np.loadtxt(self.spec.traj_csv_path, delimiter=",",
                          skiprows=1, ndmin=2)
        n1 = self.spec.traj_n + 1
        self.time_segments = [0.0]
        self.ctrl = []
        for row in rows:
            self.time_segments.append(float(row[1]))
            seg = np.zeros((n1, 3))
            for k in range(2):
                seg[:, k] = row[2 + n1 * k: 2 + n1 * (k + 1)]
            self.ctrl.append(seg)

    def state(self, t: float):
        m = 0
        while m < len(self.ctrl) - 1 and t > self.time_segments[m + 1]:
            m += 1
        t0, t1 = self.time_segments[m], self.time_segments[m + 1]
        tau = np.clip((t - t0) / max(t1 - t0, 1e-9), 0.0, 1.0)
        seg = self.ctrl[m]
        n = seg.shape[0] - 1
        pos = _bernstein_row(n, tau) @ seg
        vel_c = (seg[1:] - seg[:-1]) * (n / (t1 - t0))
        vel = _bernstein_row(n - 1, tau) @ vel_c
        return pos, vel


def _bernstein_row(n: int, tau: float) -> np.ndarray:
    """Basis values b_{i,n}(tau), i = 0..n (0^0 = 1)."""
    i = np.arange(n + 1)
    binom = np.asarray([nchoosek(n, k) for k in i], np.float64)
    return binom * tau ** i * (1.0 - tau) ** (n - i)


_MODEL_MAP = {
    "spin": SpinObstacle, "straight": StraightObstacle,
    "multisim_patrol": PatrolObstacle, "chasing": ChasingObstacle,
    "gaussian": GaussianObstacle, "static": StaticObstacle,
    "bernstein": BernsteinObstacle,
}


def build_models(mission: Mission, seed: int = 0) -> List[ObstacleModel]:
    models = []
    for oi, spec in enumerate(mission.obstacles):
        cls = _MODEL_MAP[spec.kind]
        if cls is GaussianObstacle:
            models.append(cls(spec, seed=seed + oi))
        else:
            models.append(cls(spec))
    return models


@dataclasses.dataclass
class ObstacleGenerator:
    """Evaluates all mission obstacles at t with optional observation noise
    (ObstacleGenerator::update/updateObstaclesMsg,
    obstacle_generator.hpp:33-54, :120-142)."""
    mission: Mission
    noise_std: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self.models = build_models(self.mission, seed=self.seed)
        self.rng = np.random.default_rng(self.seed + 12345)
        self._pos = np.zeros((len(self.models), 3))
        self._vel = np.zeros((len(self.models), 3))

    def update(self, t: float):
        for oi, m in enumerate(self.models):
            self._pos[oi], self._vel[oi] = m.state(t)
        return self._pos, self._vel

    def observed(self, n_observers: int = None):
        """Positions with injected Gaussian observation noise
        (updateObstaclesMsg, obstacle_generator.hpp:120-142 -- the
        reference draws a FRESH noise sample for every agent's
        ObstacleArray message, so each agent sees an independent
        observation; seedable here).

        n_observers None -> one shared sample (O, 3); n -> independent
        per-agent samples (n, O, 3)."""
        if n_observers is None:
            if self.noise_std <= 0:
                return self._pos.copy()
            return self._pos + self.rng.normal(0, self.noise_std,
                                               self._pos.shape)
        out = np.broadcast_to(self._pos[None],
                              (n_observers,) + self._pos.shape).copy()
        if self.noise_std > 0:
            out += self.rng.normal(0, self.noise_std, out.shape)
        return out

    @property
    def radii(self):
        return np.asarray([m.radius for m in self.models])

    @property
    def downwash(self):
        return np.asarray([m.spec.downwash for m in self.models])

    @property
    def max_acc(self):
        return np.asarray([m.spec.max_acc for m in self.models])
