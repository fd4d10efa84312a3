"""The planner parameters the reference runs (a frozen copy of the port's
``config.py``, cut to the keys the benchmark's configurations set and the
defaults the cycle reads; see the LSC reference's ``src/param.cpp:4-144``
and ``launch/simulation.launch:30-97``).  The reference runs one mode of
each kind: the LSC planner, previous-solution prediction and initial
trajectory, PRIOR_BASED goals with the deadlock rescue, the
distance-scaled terminal weight, a 3-D world.  ``from_dict`` refuses any
other mode and any key it does not know.
"""
from __future__ import annotations

import dataclasses
import enum

SP_EPSILON = 1e-9
SP_EPSILON_FLOAT = 1e-6
SP_INFINITY = 1e9


class PlannerMode(enum.Enum):
    LSC = "lsc"


class PredictionMode(enum.Enum):
    PREVIOUS_SOLUTION = "previous_solution"


class InitialTrajMode(enum.Enum):
    PREVIOUS_SOLUTION = "previous_solution"


class GoalMode(enum.Enum):
    PRIOR_BASED = "prior_based"


@dataclasses.dataclass
class Param:
    """Planner parameters, defaults as the port's ``Param`` has them."""

    world_resolution: float = 0.1
    multisim_time_step: float = 0.2
    multisim_record_time_step: float = 0.1
    # the host loop's mission cap: the harness restarts missions itself
    multisim_max_planner_iteration: int = 1000

    planner_mode: PlannerMode = PlannerMode.LSC
    prediction_mode: PredictionMode = PredictionMode.PREVIOUS_SOLUTION
    initial_traj_mode: InitialTrajMode = InitialTrajMode.PREVIOUS_SOLUTION
    goal_mode: GoalMode = GoalMode.PRIOR_BASED

    # trajectory representation
    dt: float = 0.2
    horizon: float = 1.0
    n: int = 5           # Bernstein degree
    phi: int = 3         # derivative order minimized (jerk)
    phi_n: int = 1

    # optimization
    control_input_weight: float = 0.01
    terminal_weight: float = 1.0
    N_constraint_segments: int = -1

    # deadlock
    deadlock_velocity_threshold: float = 0.1
    deadlock_seq_threshold: int = 5
    deadlock_progress_eps: float = 0.01
    rescue_expire_cycles: int = 2

    # grid-based planner and goal
    grid_resolution: float = 0.25
    grid_margin: float = 0.1
    goal_threshold: float = 0.1
    goal_radius: float = 2.0
    priority_dist_threshold: float = 0.4

    # K-NN pruning (<= 0: all other agents)
    max_neighbors: int = -1
    # the IPM: iteration cap, early-exit tolerances, correctors, slack
    # floor, the LSC guard band and the QPFAILED threshold (see the port's
    # config.py for each)
    qp_iterations: int = 40
    qp_tol_gap: float = 1e-6
    qp_tol_rp: float = 1e-4
    qp_tol_rd: float = 0.2
    qp_tol_step: float = 1e-3
    qp_correctors: int = 1
    lsc_guard_margin: float = 0.004
    qp_failure_threshold: float = 0.05
    qp_s_min: float = 1.0
    # the port's dispatch between the fused IPM kernel and the factored
    # rows: one QP either way, and the reference solves it with factored
    # (or dense) rows whatever the value
    qp_fused_mode: str = "auto"

    @property
    def M(self) -> int:
        """Number of Bernstein segments (reference traj_planner.cpp:22)."""
        return int((self.horizon + SP_EPSILON) / self.dt)

    @property
    def n_constraint_segments(self) -> int:
        return self.M if self.N_constraint_segments < 0 else self.N_constraint_segments

    def validated(self) -> "Param":
        """LSC's coherence rule (traj_planner.cpp:427-475)."""
        if abs(self.multisim_time_step - self.dt) > SP_EPSILON_FLOAT:
            raise ValueError("LSC requires multisim_time_step == dt "
                             "(traj_planner.cpp:434)")
        if self.qp_fused_mode not in ("auto", "on", "off"):
            raise ValueError(f"qp_fused_mode {self.qp_fused_mode!r}")
        return dataclasses.replace(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Param":
        enum_fields = {
            "planner_mode": PlannerMode, "prediction_mode": PredictionMode,
            "initial_traj_mode": InitialTrajMode, "goal_mode": GoalMode,
        }
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in field_names:
                raise KeyError(f"the reference runs no param {k!r}")
            if k in enum_fields:
                v = enum_fields[k](v)
            kwargs[k] = v
        return cls(**kwargs)
