"""Port parity: whole obstacle-world missions flown in float32 by both
packages on the CPU.

Float32 rounding alone moves a mission's cycle count, and on the 2-agent
wall swaps it moves the JAX package itself far (111 cycles in f64, 151 in
f32 on test_static_obstacles.py's wall), so test_torch_grid.py holds the
port's f32 run of that wall to the f64 count, which the port's f64 run
matches exactly.  Here the port's f32 run is held to the JAX package's
f32 run, on missions of the same kinds: finished, agent and obstacle
safety >= 1, 0 QPFAILED, cycles within max(20 %, 10) of JAX's.
Run as a script, it prints each package's f32 and f64 cycle counts for
every case of CASES, and with the case "circle128" the distance flown over
the 20 all-pairs cycles of the 128-agent circle that chip_smoke.py's phase
11 flies, by each package in f32 and f64.  The cases "dyn64" and
"forest20_bt" are chip_smoke.py's phase 13 and 14 missions (its own
builders; the .bt world written and loaded on the CPU): each package's
f32 run ("forest20_bt_f64": in f64).  The cases "dyn64_oracle", "dyn64_lkf" (f32), "dyn64_oracle_f64"
and "dyn64_lkf_f64" are phase 13's 40-cycle runs of dyn64 under the ORACLE
prediction and the per-agent Kalman filters (0.02 m of noise): each
package's min safety, QPFAILED and obstacle safety, and, a line a cycle,
the max trajectory difference between the packages and each one's step
safety.  The cases of chip_smoke.py's MODE_CASES (phase 15: "bvc64",
"rsfc64", "exp64", "circle64_2d", "circle128_2d", "rh64") fly that
mission with the JAX package in f32 (a suffix "_f64": in f64; "_port":
the port's CPU run, in f32, or in f64 after "_f64") through
chip_smoke.fly_cycles, exp64 with its
injected disturbance, and print cycles, distance, safety and QPFAILED.
The cases of chip_smoke.py's ORCA_CASES (phase 16: "orca64",
"orca64_goal", "orca64_2d", "orca1024", with the same suffixes) fly that
mission through run() and print cycles, distance and safety.  The case
"rsfc64_f64_rounding" steps the port's CPU f64 rsfc64 (plain chol
versions) and runs cycles 0 and 3 again from the same state with the
chol calls rounded to f32 and with torch.cholesky_solve in f64: a line a
cycle with each run's max primal residual and gap and its trajectories'
difference from the plain run (chip_smoke.py phase 15's f64 precision
gate, F64_PRIMAL_TOL and F64_GAP_RATIO).  "--threads=N" sets torch's CPU
threads (default 1).
"""
import dataclasses
import math
import tempfile
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu.config import GoalMode
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch import missions as tmis
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim
from test_torch_cuda import forest_mission
from torch_parity import params, torch_one_thread  # noqa: F401

WORLD = (-3.0, -3.0, 0.0, 3.0, 3.0, 2.5)


def _wall(mis, half=3.0, dy=0.0, hy=2.0):
    """test_static_obstacles.py:23-30's wall (half 3, dy 0, hy 2), or the
    swap at another half width, the wall moved by dy along y or hy its
    half length."""
    m = mis.make_square_mission(2, half=half, world=(-5, -5, 0, 5, 5, 2.5))
    m.obstacles = [mis.ObstacleSpec(kind="static",
                                    pose=np.array([0.0, dy, 1.25]),
                                    dimensions=np.array([0.3, hy, 1.25]))]
    return m


# name -> (kind, arguments): the test's cases and the table's
CASES = {"wall": ("wall", {}), "wall_dy0.2": ("wall", dict(dy=0.2)),
         "wall_dy0.4": ("wall", dict(dy=0.4)),
         "wall_dy-0.6": ("wall", dict(dy=-0.6)),
         "wall_half2.5": ("wall", dict(half=2.5)),
         "wall_half3.5": ("wall", dict(half=3.5)),
         "wall_hy1.5": ("wall", dict(hy=1.5)),
         "forest1": ("forest", dict(seed=1)),
         "forest2": ("forest", dict(seed=2)),
         "forest4": ("forest", dict(seed=4))}


def _case(name):
    """(JAX mission, port mission, Param keywords) of a named case: a
    4-agent forest of 12 trees, or a wall swap at qp_iterations 20."""
    kind, kw = CASES[name]
    if kind == "forest":
        return (forest_mission(jmis, kw["seed"], 4, 12, WORLD),
                forest_mission(tmis, kw["seed"], 4, 12, WORLD),
                dict(goal_mode=GoalMode.PRIOR_BASED))
    return (_wall(jmis, **kw), _wall(tmis, **kw),
            dict(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=20))


@pytest.mark.parametrize("name", ["forest1", "forest2", "wall_half3.5"])
def test_f32_mission_cycles_match_jax_f32(name):
    jm, tm, kw = _case(name)
    jp, tp = params(**kw)
    j = JSim(jm, jp, dtype=jnp.float32).run()
    t = TSim(tm, tp, device="cpu", dtype=torch.float32).run()
    assert j["iterations"] < jp.multisim_max_planner_iteration
    assert t["iterations"] < tp.multisim_max_planner_iteration
    assert t["safety_ratio_agent"] >= 1.0 and not t["is_collided"]
    assert t["safety_ratio_obs"] >= 1.0
    assert t["qp_failures"] == 0
    band = max(0.2 * j["iterations"], 10)
    assert abs(t["iterations"] - j["iterations"]) <= band, \
        (t["iterations"], j["iterations"])


def circle128_distances(cycles=20):
    """{run: (distance flown, min safety, QPFAILED)} over `cycles` cycles
    from the initial state of the 128-agent circle swap (bench.py's radius
    rule, PRIOR_BASED, all pairs: C = 128 row groups a QP), by each
    package on the CPU in f32 and f64.  On the CPU both optimizers take
    the factored IPM at every size (the fused one is for the accelerator
    in f32), so these runs share one algorithm."""
    qn = 128
    radius = max(4.0, 0.45 * qn / math.pi)
    w = radius + 2.0
    world = (-w, -w, 0.0, w, w, 2.5)
    jm = jmis.make_circle_mission(qn, radius=radius, world=world)
    tm = tmis.make_circle_mission(qn, radius=radius, world=world)

    def fly(step, state):
        safety, failed = math.inf, 0
        for _ in range(cycles):
            state, info = step(state)
            safety = min(safety, float(info.safety_step_min))
            failed += int(np.asarray(info.qp_failed).sum())
        return float(state.distance), safety, failed

    out = {}
    for dtype, key in ((jnp.float32, "jax_f32"), (jnp.float64, "jax_f64")):
        jp = params(goal_mode=GoalMode.PRIOR_BASED)[0]
        sim = JSim(jm, jp, dtype=dtype)
        out[key] = fly(sim._cycle_jit, sim.initial_state())
    for dtype, key in ((torch.float32, "port_f32"),
                       (torch.float64, "port_f64")):
        tp = params(goal_mode=GoalMode.PRIOR_BASED)[1]
        sim = TSim(tm, tp, device="cpu", dtype=dtype)
        out[key] = fly(sim.cycle, sim.initial_state())
    return out


def jax_mission(tm):
    """The JAX package's Mission with the fields of the port's Mission tm."""
    d = {f.name: getattr(tm, f.name) for f in dataclasses.fields(tm)}
    d["agents"] = [jmis.AgentSpec(**dataclasses.asdict(a))
                   for a in tm.agents]
    d["obstacles"] = [jmis.ObstacleSpec(**dataclasses.asdict(o))
                      for o in tm.obstacles]
    return jmis.Mission(**d)


def chip_smoke_runs(name):
    """{run: summary} of chip_smoke.py's dyn64 or forest20_bt mission, each
    package's SyncSimulator.run() on the CPU in f32 (forest20_bt_f64: in
    f64) (PRIOR_BASED, Param defaults; the .bt world with
    world_use_octomap, each package's own ESDF.from_bt of the same
    file)."""
    import chip_smoke
    from lsc_planner_tpu.world.esdf import ESDF as JESDF
    from lsc_planner_tpu_torch.world.esdf import ESDF as TESDF

    kw = dict(goal_mode=GoalMode.PRIOR_BASED)
    dt = "f64" if name.endswith("_f64") else "f32"
    jdt, tdt = ((jnp.float64, torch.float64) if dt == "f64"
                else (jnp.float32, torch.float32))
    jesdf = tesdf = None
    if name == "dyn64":
        tm = chip_smoke.dyn64_mission()
    else:
        kw["world_use_octomap"] = True
        with tempfile.TemporaryDirectory() as tmpdir:
            tm, _ = chip_smoke.forest20_bt_world("cpu", tmpdir)
            path = tmpdir + "/forest20.bt"
            jesdf = JESDF.from_bt(path, tm.world_min, tm.world_max,
                                  dtype=jdt)
            tesdf = TESDF.from_bt(path, tm.world_min, tm.world_max,
                                  dtype=tdt, device="cpu")
    jp, tp = params(**kw)
    return {"jax_" + dt: JSim(jax_mission(tm), jp, esdf=jesdf,
                              dtype=jdt).run(),
            "port_" + dt: TSim(tm, tp, device="cpu", esdf=tesdf,
                               dtype=tdt).run()}


DYN64_MODES = {"dyn64_oracle": ("ORACLE", 0.0, "f32"),
               "dyn64_lkf": ("LINEAR_KALMAN_FILTER", 0.02, "f32"),
               "dyn64_oracle_f64": ("ORACLE", 0.0, "f64"),
               "dyn64_lkf_f64": ("LINEAR_KALMAN_FILTER", 0.02, "f64")}


def dyn64_mode_runs(name, cycles=40):
    """Both packages' run() of `cycles` cycles of chip_smoke.py's dyn64
    under the prediction mode of DYN64_MODES[name], set after validated()
    as the JAX package's tests set it.  Returns (a (max |traj diff|, JAX
    step safety, port step safety) tuple a cycle, {run: summary})."""
    import chip_smoke
    from lsc_planner_tpu.config import PredictionMode

    mode, noise, dt = DYN64_MODES[name]
    jp, tp = params(goal_mode=GoalMode.PRIOR_BASED, obs_observer_stddev=noise)
    jdt, tdt = ((jnp.float64, torch.float64) if dt == "f64"
                else (jnp.float32, torch.float32))
    jsim = JSim(jax_mission(chip_smoke.dyn64_mission()), jp, dtype=jdt)
    tsim = TSim(chip_smoke.dyn64_mission(), tp, device="cpu", dtype=tdt)
    jsim.param.prediction_mode = PredictionMode[mode]
    tsim.param.prediction_mode = type(tsim.param.prediction_mode)[mode]
    jt, tt = [], []

    def jcycle(state, *dyn):
        out = jsim._cycle_jit(state, *dyn)
        jt.append((np.asarray(out[0].traj), float(out[1].safety_step_min)))
        return out
    tcycle = tsim.cycle

    def trec(state, *dyn):
        out = tcycle(state, *dyn)
        tt.append((out[0].traj.numpy().copy(),
                   float(out[1].safety_step_min)))
        return out
    tsim.cycle = trec
    runs = {"jax_" + dt: jsim.run(max_iterations=cycles, cycle_fn=jcycle),
            "port_" + dt: tsim.run(max_iterations=cycles)}
    per_cycle = [(float(np.abs(a[0] - b[0]).max()), a[1], b[1])
                 for a, b in zip(jt, tt)]
    return per_cycle, runs


def mode_run(name):
    """chip_smoke.py's phase-15 case `name` (a MODE_CASES key, with an
    optional suffix "_f64" or "_port"): chip_smoke.fly_cycles' dict."""
    import enum

    import chip_smoke
    from lsc_planner_tpu import config as jcfg

    base = name.split("_f64")[0].split("_port")[0]
    tm, kw, cycles = chip_smoke.mode_case(base)
    cycles = cycles or 1000
    if name.endswith("_port"):
        sim = TSim(tm, chip_smoke.Param(**kw), device="cpu",
                   dtype=torch.float64 if "_f64" in name else torch.float32)
        step = sim.cycle
    else:
        jkw = {k: getattr(jcfg, type(v).__name__)[v.name]
               if isinstance(v, enum.Enum) else v for k, v in kw.items()}
        sim = JSim(chip_smoke.mode_case(base, jmis)[0], jcfg.Param(**jkw),
                   dtype=jnp.float64 if name.endswith("_f64")
                   else jnp.float32)
        step = sim._cycle_jit
    out = chip_smoke.fly_cycles(sim, step, cycles,
                                inject=base == "exp64")
    out.pop("state")
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in out.items()}


def orca_run(name):
    """chip_smoke.py's phase-16 case `name` (an ORCA_CASES key, with an
    optional suffix "_f64" or "_port"): run() to the finish (under
    chip_smoke.ORCA_CAP) or for the case's cycles, the JAX package's f32
    runs with x64 off; cycles, distance, min safety, ms a cycle."""
    import enum

    import chip_smoke
    from lsc_planner_tpu import config as jcfg

    base = name.split("_f64")[0].split("_port")[0]
    tm, kw, cycles = chip_smoke.orca_case(base)
    if name.endswith("_port"):
        sim = TSim(tm, chip_smoke.Param(**kw), device="cpu",
                   dtype=torch.float64 if "_f64" in name else torch.float32)
    else:
        jkw = {k: getattr(jcfg, type(v).__name__)[v.name]
               if isinstance(v, enum.Enum) else v for k, v in kw.items()}
        sim = JSim(chip_smoke.orca_case(base, jmis)[0], jcfg.Param(**jkw),
                   dtype=jnp.float64 if name.endswith("_f64")
                   else jnp.float32)
    if name.endswith(("_f64", "_port")):
        r = sim.run(max_iterations=cycles or chip_smoke.ORCA_CAP)
    else:
        # JAX's own f32 setting: under x64 its 2-D pinning planes
        # (jnp.zeros) are f64 and its f32 ORCA solve fails to trace
        with jax.enable_x64(False):
            r = sim.run(max_iterations=cycles or chip_smoke.ORCA_CAP)
    return dict(cycles=int(r["iterations"]),
                finished=bool(r["total_flight_time"] ==
                              r["total_flight_time"]),
                distance=float(r["total_flight_distance"]),
                safety=float(r["safety_ratio_agent"]),
                ms_per_cycle=1e3 * float(r["wall_time"]) / r["iterations"])


def rounding_runs(probe=(0, 3)):
    """rsfc64 in f64 on the CPU with the plain chol versions, stepped for
    max(probe) + 1 cycles; each cycle of probe run again from the same
    state with the chol calls rounded to f32 and with
    torch.cholesky_solve in f64: [(cycle, {run: (max primal residual, max
    gap, max |traj diff| from the plain run (m), QPFAILED agents)})]."""
    import chip_smoke
    from lsc_planner_tpu_torch.ops import chol

    def fs32(H, rhs):
        L, x = chol.chol_factor_solve_plain(H.float(), rhs.float())
        return L.double(), x.double()

    def solve64(L, rhs):
        return torch.cholesky_solve(rhs.unsqueeze(-1), L).squeeze(-1)

    ways = {"f32 rounding": (fs32, lambda L, rhs: chol.chol_resolve_plain(
                L.float(), rhs.float()).double()),
            "f64 cholesky_solve": (lambda H, rhs: (
                chol.cholesky_batched_plain(H),
                solve64(chol.cholesky_batched_plain(H), rhs)), solve64)}
    tm, kw, _ = chip_smoke.mode_case("rsfc64")
    sim = TSim(tm, chip_smoke.Param(**kw), device="cpu",
               dtype=torch.float64)
    state, out = sim.initial_state(), []
    for it in range(max(probe) + 1):
        prev = state
        state, (failed, res, gap) = chip_smoke.cycle_qp(sim, prev)
        if it not in probe:
            continue
        runs = {"plain f64": (float(res.max()), float(gap.max()), 0.0,
                              failed)}
        fs, rs = chol.chol_factor_solve, chol.chol_resolve
        for label, (f, r) in ways.items():
            chol.chol_factor_solve, chol.chol_resolve = f, r
            try:
                other, (f2, r2, g2) = chip_smoke.cycle_qp(sim, prev)
            finally:
                chol.chol_factor_solve, chol.chol_resolve = fs, rs
            runs[label] = (float(r2.max()), float(g2.max()),
                           float((other.traj - state.traj).abs().max()), f2)
        out.append((it, runs))
    return out


def main(names):
    """Print, a JSON line a case, the cycles, safety and distance of the
    JAX package's and the port's CPU runs in f32 and f64."""
    import json
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    threads = [a for a in names if a.startswith("--threads=")]
    names = [a for a in names if a not in threads]
    torch.set_num_threads(int(threads[-1].split("=")[1]) if threads else 1)
    import chip_smoke
    for name in names:
        if name == "rsfc64_f64_rounding":
            for it, runs in rounding_runs():
                print(json.dumps({"case": name, "cycle": it, **{
                    k: dict(zip(("primal", "gap", "traj_diff", "qp_failed"),
                                v)) for k, v in runs.items()}}), flush=True)
            continue
        if name.split("_f64")[0].split("_port")[0] in chip_smoke.ORCA_CASES:
            print(json.dumps({"case": name, **orca_run(name)}), flush=True)
            continue
        if name.split("_f64")[0].split("_port")[0] in chip_smoke.MODE_CASES:
            print(json.dumps({"case": name, **mode_run(name)}), flush=True)
            continue
        if name == "circle128":
            print(json.dumps({"case": name, **{
                key: dict(zip(("distance", "safety", "qp_failures"), v))
                for key, v in circle128_distances().items()}}), flush=True)
            continue
        if name in DYN64_MODES:
            per_cycle, runs = dyn64_mode_runs(name)
            for k, (diff, js, ts) in enumerate(per_cycle):
                print(json.dumps({"case": name, "cycle": k, "traj_diff": diff,
                                  "jax_safety": js, "port_safety": ts}))
            print(json.dumps({"case": name, **{key: dict(
                cycles=int(r["iterations"]),
                safety=float(r["safety_ratio_agent"]),
                obstacle_safety=float(r["safety_ratio_obs"]),
                qp_failures=int(r["qp_failures"]))
                for key, r in runs.items()}}), flush=True)
            continue
        if name in ("dyn64", "forest20_bt", "forest20_bt_f64"):
            print(json.dumps({"case": name, **{key: dict(
                cycles=int(r["iterations"]),
                safety=float(r["safety_ratio_agent"]),
                obstacle_safety=float(r["safety_ratio_obs"]),
                qp_failures=int(r["qp_failures"]),
                distance=float(r["total_flight_distance"]))
                for key, r in chip_smoke_runs(name).items()}}), flush=True)
            continue
        jm, tm, kw = _case(name)
        jp, tp = params(**kw)
        out = {"case": name}
        for key, run in (
                ("jax_f32", lambda: JSim(jm, jp, dtype=jnp.float32).run()),
                ("jax_f64", lambda: JSim(jm, jp, dtype=jnp.float64).run()),
                ("port_f32", lambda: TSim(tm, tp, device="cpu",
                                          dtype=torch.float32).run()),
                ("port_f64", lambda: TSim(tm, tp, device="cpu",
                                          dtype=torch.float64).run())):
            r = run()
            out[key] = dict(cycles=int(r["iterations"]),
                            safety=float(r["safety_ratio_agent"]),
                            obstacle_safety=float(r["safety_ratio_obs"]),
                            qp_failures=int(r["qp_failures"]),
                            distance=float(r["total_flight_distance"]))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
    #     python tests/test_torch_f32_missions.py [--threads=N] [case ...]
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    main(flags + ([a for a in sys.argv[1:] if a not in flags] or
                  list(CASES)))
