"""Typed configuration for the LSC swarm planner (the port's own copy of
lsc_planner_tpu/config.py, kept identical in content so both packages read
the same parameters; a test holds the two equal).

Single-source-of-truth replacement for the reference's three-tier config stack
(launch args -> ROS param server -> mission JSON); see reference
``src/param.cpp:4-144`` and ``launch/simulation.launch:30-97`` for the canonical
key set and defaults.  Mode-coherence rules mirror
``src/traj_planner.cpp:427-475`` (checkPlannerMode).
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Optional

SP_EPSILON = 1e-9
SP_EPSILON_FLOAT = 1e-6
SP_INFINITY = 1e9


class PlannerMode(enum.Enum):
    LSC = "lsc"
    BVC = "bvc"
    ORCA = "orca"
    RECIPROCAL_RSFC = "reciprocal_rsfc"


class PredictionMode(enum.Enum):
    POSITION = "current_position"
    VELOCITY = "constant_velocity"
    LINEAR_KALMAN_FILTER = "linear_kalman_filter"
    ORACLE = "oracle"
    ORCA = "orca"
    PREVIOUS_SOLUTION = "previous_solution"


class InitialTrajMode(enum.Enum):
    GREEDY = "greedy"
    ORCA = "orca"
    POSITION = "current_position"
    VELOCITY = "current_velocity"
    PREVIOUS_SOLUTION = "previous_solution"
    SKIP = "skip"


class SlackMode(enum.Enum):
    NONE = "none"
    DYNAMICAL_LIMIT = "dynamical_limit"
    COLLISION_CONSTRAINT = "collision_constraint"


class GoalMode(enum.Enum):
    STATIC = "static"
    ORCA = "orca"
    RIGHT_HAND = "right_hand"
    PRIOR_BASED = "prior_based"


class PlannerState(enum.Enum):
    WAIT = 0
    GOTO = 1
    PATROL = 2
    GOBACK = 3


class PlanningReport(enum.Enum):
    QP_FAILED = -2
    WAIT_FOR_MSG = -1
    INITIALIZED = 0
    SUCCESS = 1


@dataclasses.dataclass
class Param:
    """Planner parameters (reference ``include/param.hpp`` key-for-key).

    Defaults follow ``launch/simulation.launch:30-97`` (the benchmark preset),
    not the C++ fallback defaults, since every published result uses the
    launch-file values.
    """

    # --- world (reference param.cpp:9-15) ---
    world_frame_id: str = "world"
    world_dimension: int = 3
    world_use_octomap: bool = False
    world_resolution: float = 0.1
    world_z_2d: float = 1.0

    # --- multisim (param.cpp:17-29) ---
    multisim_planning_rate: float = -1.0
    multisim_qn: int = 2
    multisim_time_step: float = 0.2
    multisim_patrol: bool = False
    multisim_max_noise: float = 0.0
    multisim_max_planner_iteration: int = 1000
    multisim_save_result: bool = False
    multisim_replay: bool = False
    multisim_replay_file_name: str = "default.csv"
    multisim_experiment: bool = False
    multisim_record_time_step: float = 0.1
    multisim_reset_threshold: float = 0.15

    # --- modes (param.cpp:31-58) ---
    planner_mode: PlannerMode = PlannerMode.LSC
    prediction_mode: PredictionMode = PredictionMode.PREVIOUS_SOLUTION
    initial_traj_mode: InitialTrajMode = InitialTrajMode.PREVIOUS_SOLUTION
    slack_mode: SlackMode = SlackMode.NONE
    goal_mode: GoalMode = GoalMode.PRIOR_BASED

    # --- obstacle prediction (param.cpp:60-63) ---
    obs_size_prediction: bool = True
    obs_uncertainty_horizon: float = 1.0
    # NOTE: the reference's `obs/agent_clustering` key (param.cpp:63) is
    # parsed there but never read by any reference code; it is
    # deliberately NOT a field here.  Configs that still set it are
    # accepted and ignored (see cli.py override handling).
    # per-agent obstacle observation noise stddev
    # (updateObstaclesMsg, obstacle_generator.hpp:120-142; the
    # reference's mainline call passes it commented out,
    # multi_sync_simulator.cpp:259)
    obs_observer_stddev: float = 0.0

    # --- trajectory representation (param.cpp:65-70) ---
    dt: float = 0.2
    horizon: float = 1.0
    n: int = 5           # Bernstein degree
    phi: int = 3         # derivative order minimized (jerk)
    phi_n: int = 1

    # --- optimization (param.cpp:72-76) ---
    control_input_weight: float = 0.01
    terminal_weight: float = 1.0
    # Terminal-weight schedule: "distance" (default) uses the reference
    # authors' clamped distance-scaled variant min(w / dist_to_goal, 10)
    # (traj_optimizer.cpp:345-352); "simple" uses the constant weight
    # the reference ships (:353-355).  See
    # TrajOptimizer._terminal_weight for why "distance" is the default
    # here (the constant weight leaves a weakly-damped endgame ring that
    # strands finishes).
    terminal_weight_mode: str = "distance"
    slack_collision_weight: float = 100000.0
    N_constraint_segments: int = -1

    # --- deadlock (param.cpp:78-80) ---
    deadlock_velocity_threshold: float = 0.1
    deadlock_seq_threshold: int = 5

    # --- kalman filter (param.cpp:82-85) ---
    filter_sigma_y_sq: float = 0.0036
    filter_sigma_v_sq: float = 0.01
    filter_sigma_a_sq: float = 1.0

    # --- orca (param.cpp:87-90) ---
    orca_horizon: float = 2.0
    orca_pref_velocity_ratio: float = 1.0
    orca_inflation_ratio: float = 1.0

    # --- grid-based planner (param.cpp:92-94) ---
    grid_resolution: float = 0.25
    grid_margin: float = 0.1

    # --- goal (param.cpp:96-99) ---
    goal_threshold: float = 0.1
    goal_radius: float = 2.0
    priority_dist_threshold: float = 0.4

    # --- debug ---
    debug_stop_seq: int = -1
    log: bool = False

    # --- TPU-native extensions (no reference analog) ---
    # Number of nearest-neighbour obstacles each agent constrains against.
    # <=0 means "all other agents" (reference behaviour).  Spatial pruning is
    # the CP/ring analog from SURVEY.md section 5.7 for 1000+ agent scaling.
    max_neighbors: int = -1
    # Batched QP interior-point iterations (static for jit).  This is a
    # CAP: the fused TPU kernel exits early once every agent in a lane
    # tile reaches qp_tol_gap / qp_tol_rp (warm-started steady-state
    # cycles typically converge in well under half the cap).  The cap
    # must leave headroom for CONGESTED cycles: at 14 iterations the
    # solver returns feasible-but-suboptimal points in dense swarms
    # (~1500 active-set-heavy rows) and the warm-start feedback locks
    # agents into hover orbits short of their goals (empty-world
    # 20-agent corpus missions never finished); 40 breaks every observed
    # orbit while early exit keeps steady-state cycles cheap.
    qp_iterations: int = 40
    # Early-exit tolerances for the IPM: complementarity gap, max primal
    # residual, and max dual residual |Py + q - A'lam|.  Gap and dual
    # residual are measured on the UNIT-NORMALIZED objective (the solver
    # rescales P, q to O(1) per instance -- raw jerk-Gram scale ~1e5
    # stalls f32 Newton steps and floors the gap at ~eps*scale); rows
    # are unit-norm equilibrated so the primal residual is in meters at
    # the constraint surface.  All THREE must hold to exit: with a warm
    # start at the previous cycle's optimum, gap + primal alone are
    # satisfied after 1-2 iterations while y is still the STALE optimum
    # (Mehrotra collapses mu first) -- exiting there freezes the agent
    # (the round-3 endgame-stall regression).  qp_tol_rd is ABSOLUTE in
    # raw objective-gradient units: the stale-point residual is the
    # goal-pull force ~ 2 w_t dist, and with the distance-scaled
    # terminal weight (w_t = clip(w/dist, w, 10w)) it stays >= ~2 for
    # any unfinished agent.  The f32 floor of EVALUATING r_d at a
    # converged iterate (delta-coordinate solve) is ~0.03 on CPU and
    # ~0.1-0.15 on TPU (bf16x6 'highest' emulation constants); 0.2
    # sits above the TPU floor with a ~10x margin to the stale signal.
    # Measured round 5 on captured production instances: the fused
    # kernel exits at 9/40 iterations at tol_rd in [0.15, 1.0] and
    # never below 0.15 on TPU.  Setting any tolerance to 0 disables
    # early exit (fixed iteration count; used by tests that need
    # cross-path determinism).
    qp_tol_gap: float = 1e-6
    qp_tol_rp: float = 1e-4
    qp_tol_rd: float = 0.2
    # f32 fixed-point step tolerance: with gap + primal converged, a
    # lane whose applied primal step fell below this (metres in
    # control-point deltas; the observed f32 jitter band is 1-2.5 cm,
    # this sits 10-25x under it) is latched even when r_d cannot be
    # certified -- at 1024-agent congestion the r_d evaluation floor
    # exceeds 4 raw units for fully-converged lanes (dual magnitudes
    # scale it), and iterating past the fixed point is what DEGRADES
    # iterates, not what improves them.
    qp_tol_step: float = 1e-3
    # Gondzio centrality correctors per IPM iteration (0 = plain
    # Mehrotra).  The LSC structure replicates each neighbour's plane
    # over ~M(n+1) near-identical rows whose degenerate duals stall
    # plain Mehrotra at congestion (gap plateau ~1e-2,
    # docs/TOLERANCES_r03.md); ONE corrector collapses the plateau to
    # ~1e-5 at 14 iterations (measured on a captured congested
    # 64-agent instance) for two extra triangular substitutions per
    # iteration -- no extra factorization.
    qp_correctors: int = 1
    # Feasibility-preserving LSC guard band (metres).  A capped f32 IPM
    # leaves mm-scale primal error; at congested steady state corpus
    # safety ratios then sit one ulp either side of 1.0 (observed:
    # 0.9929-1.0000 on the dense empty/forest sets).  Each LSC margin is
    # inflated by min(guard, s0/2) where s0 is the row's slack at the
    # initial trajectory, which provably preserves the LSC feasibility
    # lemma (see planner/constraints.lsc_planes).  The reference needs
    # no guard: CPLEX solves in f64 to ~1e-9 (traj_optimizer.cpp:31-154).
    lsc_guard_margin: float = 0.004
    # Fused single-launch Pallas IPM dispatch: "auto" (TPU/f32, swarms
    # >= qp_fused_min_agents), "on" (every size), "off" (always the XLA
    # factored-row path; diagnostic A/B switch).  Same solver contract
    # either way; see planner/optimizer.py for the size gate rationale.
    qp_fused_mode: str = "auto"
    # Minimum swarm size for the fused kernel under "auto": below this
    # the per-dispatch overhead the kernel amortizes is negligible and
    # its hardware solutions measurably trail the XLA path in downstream
    # trajectory quality at congestion (multi_square16+forest, TPU f32,
    # seeds {1,2,11}: fused 180-223 cycles vs XLA 147-155 -- a known
    # round-5 gap documented in docs/TOLERANCES_r05.md).
    qp_fused_min_agents: int = 128
    # QP failure surfacing (QPFAILED analog).  The reference throws from
    # CPLEX, dumps the model + refined conflict, and aborts the whole
    # run (traj_optimizer.cpp:99-144, multi_sync_simulator.cpp:325-327).
    # Here an agent whose solution violates constraints beyond this
    # threshold (meters at the unit-norm constraint surface) is reported
    # QPFAILED -- and, because the LSC-shifted previous solution is
    # feasible by construction, it falls back to that instead of flying
    # the violating trajectory (graceful degradation the reference's
    # abort-only design cannot offer).
    qp_failure_threshold: float = 0.05
    # Abort the run() loop on any QPFAILED report (strict reference
    # behaviour); off by default since the fallback keeps the swarm safe.
    multisim_abort_on_qp_failure: bool = False
    # Floor on the warm-start slacks (s0 = max(A y0 - b, s_min)).  Large
    # values re-center the iterate far from the warm point (robust but
    # slow to converge); small values keep the warm start's activity
    # pattern so steady-state cycles converge in fewer iterations.
    qp_s_min: float = 1.0
    # Batched convex-hull closest-point iterations (static for jit).
    hull_iterations: int = 96
    # Fixed iteration cap for SFC box expansion (per axis sweep).
    sfc_expansion_cap: int = 256
    # LOS ray admissibility check: False = fixed fine sampling at
    # <= resolution/2 spacing (a valid sphere cover, cheaper at 1000+
    # agents); True = the reference castRay's recursive-bisection
    # semantics exactly (grid_based_planner.cpp:409-433), as a bottom-up
    # DP over dyadic segments -- use for behavioural parity runs.  The
    # exact mode also disables the origin-clearance escape clamp (a
    # robustness extension the reference does not have).
    grid_los_exact_castray: bool = False
    # Apply the right-hand-rule goal displacement
    # (traj_planner.cpp:528-538) inside priority-based goal planning when
    # an agent is deadlocked (wedged against agents/trees with a frozen
    # LOS goal).  Extension beyond the reference, which leaves such local
    # minima to chance; disable for strict behavioural parity.
    deadlock_rescue: bool = True
    # Stall-count hysteresis: the count (which drives rescue escalation)
    # resets only when an agent closes on its desired goal by at least
    # this much in one cycle; velocity alone never resets it, so the
    # rescue push can't cancel its own escalation.
    deadlock_progress_eps: float = 0.01
    # An ACTIVE rescue rung whose agent stays fully immobile is
    # unreachable (outside the collapsed corridor); expire it after this
    # many stalled cycles instead of the full engagement threshold.  A
    # rung that moves the agent keeps velocity above the stall threshold
    # and never trips the short clock.
    rescue_expire_cycles: int = 2
    # float dtype used on device
    dtype: str = "float32"

    @property
    def M(self) -> int:
        """Number of Bernstein segments (reference traj_planner.cpp:22)."""
        return int((self.horizon + SP_EPSILON) / self.dt)

    @property
    def n_constraint_segments(self) -> int:
        return self.M if self.N_constraint_segments < 0 else self.N_constraint_segments

    def validated(self) -> "Param":
        """Apply the mode-coherence rewrites of traj_planner.cpp:427-475."""
        p = dataclasses.replace(self)
        if p.planner_mode == PlannerMode.LSC:
            if abs(p.multisim_time_step - p.dt) > SP_EPSILON_FLOAT:
                raise ValueError(
                    "LSC requires multisim_time_step == dt "
                    "(traj_planner.cpp:434)")
            p.prediction_mode = PredictionMode.PREVIOUS_SOLUTION
            p.initial_traj_mode = InitialTrajMode.PREVIOUS_SOLUTION
            p.slack_mode = SlackMode.NONE
        elif p.planner_mode == PlannerMode.BVC:
            p.prediction_mode = PredictionMode.POSITION
            p.initial_traj_mode = InitialTrajMode.POSITION
        elif p.planner_mode == PlannerMode.RECIPROCAL_RSFC:
            p.slack_mode = SlackMode.COLLISION_CONSTRAINT
        if p.n != 5 or p.phi != 3:
            # reference traj_optimizer.cpp:204-207 hard-codes n=5/phi=3; we
            # support general n via the generic basis code but flag deviation.
            pass
        return p

    def planner_mode_str(self) -> str:
        return {PlannerMode.LSC: "LSC", PlannerMode.BVC: "BVC",
                PlannerMode.ORCA: "ORCA",
                PlannerMode.RECIPROCAL_RSFC: "ReciprocalRSFC"}[self.planner_mode]

    @classmethod
    def from_dict(cls, d: dict) -> "Param":
        kwargs = {}
        enum_fields = {
            "planner_mode": PlannerMode, "prediction_mode": PredictionMode,
            "initial_traj_mode": InitialTrajMode, "slack_mode": SlackMode,
            "goal_mode": GoalMode,
        }
        field_names = {f.name for f in dataclasses.fields(cls)}
        # reference keys that exist in param.cpp but are read by no
        # reference code; accepted and dropped for config compatibility
        dead_reference_keys = {"obs_agent_clustering"}
        for k, v in d.items():
            if k in dead_reference_keys:
                continue
            if k not in field_names:
                raise KeyError(f"unknown param {k!r}")
            if k in enum_fields and isinstance(v, str):
                v = enum_fields[k](v)
            kwargs[k] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str) -> "Param":
        with open(path) as f:
            return cls.from_dict(json.load(f))
