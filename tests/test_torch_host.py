"""Port parity: the host surface against the JAX package -- the Bernstein
root helpers and the continuous safety audit, the result/summary CSV
logging and its replay, the command sampler, the message schema, the LP
file reader, the debugger's dumps, stage profiles and the CLI.

Stated tolerances: the root helpers and continuous_safety_ratio within
1e-9 of JAX in f64; the port's result CSV of the 4-agent mission within
1e-5 m of the JAX package's CSV of the same f64 run (compare_runs).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.ops import bernstein as jbz
from lsc_planner_tpu.sim import audit as jaudit
from lsc_planner_tpu.sim import lpfile as jlp
from lsc_planner_tpu.sim.logging import ResultLogger as JLogger
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch import cli
from lsc_planner_tpu_torch.config import GoalMode, Param, PlannerMode
from lsc_planner_tpu_torch.missions import load_mission, make_circle_mission
from lsc_planner_tpu_torch.ops import bernstein as tbz
from lsc_planner_tpu_torch.sim import audit as taudit
from lsc_planner_tpu_torch.sim import lpfile as tlp
from lsc_planner_tpu_torch.sim import msgs
from lsc_planner_tpu_torch.sim.command import CommandSampler
from lsc_planner_tpu_torch.sim.debug import DebugRecorder
from lsc_planner_tpu_torch.sim.logging import ResultLogger, append_summary
from lsc_planner_tpu_torch.sim.replay import compare_runs, read_result_csv
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as _TSim
from torch_parity import (missions, params, port_state,  # noqa: F401
                          torch_one_thread)

TOL = 1e-9


def TSim(mission, param, **kw):
    return _TSim(mission, param, device="cpu", **kw)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


# ------------------------------------------------- the Bernstein root helpers
def test_power_coeffs_poly_eval_multiply(rng):
    """tests/test_bernstein.py's 5 scalar curves: monomial coefficients, a
    Horner evaluation at five times (equal to the curve's value) and the
    products of the coefficient sets, against JAX."""
    ctrl = rng.normal(size=(5, 6))
    coef = tbz.power_coeffs(_t(ctrl))
    _close(coef, jbz.power_coeffs(jnp.asarray(ctrl)))
    for t in (0.0, 0.17, 0.5, 0.93, 1.0):
        _close(tbz.poly_eval(coef, t),
               jbz.poly_eval(jbz.power_coeffs(jnp.asarray(ctrl)), t))
        _close(tbz.poly_eval(coef, t),
               jbz.bernstein_eval(jnp.asarray(ctrl)[..., None], t)[..., 0])
    other = rng.normal(size=(5, 4))
    _close(tbz.poly_multiply(coef, _t(other)),
           jbz.poly_multiply(jbz.power_coeffs(jnp.asarray(ctrl)),
                             jnp.asarray(other)))


@pytest.mark.parametrize("roots,n_grid", [((0.3, 0.7, -1.0), 64),
                                          ((0.5,), 64)])
def test_real_roots_match(roots, n_grid):
    """tests/test_bernstein.py's polynomials: (t - 0.3)(t - 0.7)(t + 1)
    and t - 0.5 (a root on a grid point); the same roots and masks as
    JAX."""
    coef = np.poly(np.array(roots))[::-1].copy()
    got, mask = tbz.real_roots(_t(coef), n_grid=n_grid)
    want, wmask = jbz.real_roots(jnp.asarray(coef), n_grid=n_grid)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    _close(got, want)
    found = np.sort(got.numpy()[mask.numpy()])
    np.testing.assert_allclose(found, sorted(r for r in roots
                                             if 0 <= r <= 1), atol=1e-9)


def test_curve_pair_min_distance_match(rng):
    """tests/test_bernstein.py's brute-force case (8 random curve pairs)
    and its endpoint case, against JAX."""
    a, b = rng.normal(size=(8, 6, 3)) * 2.0, rng.normal(size=(8, 6, 3)) * 2.0
    got = tbz.curve_pair_min_distance(_t(a), _t(b))
    want = jbz.curve_pair_min_distance(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        _close(g, w)
    a = np.linspace([0, 0, 0], [5, 0, 0], 6)
    b = np.linspace([0, 1, 0], [-5, 1, 0], 6)
    dist, _ = tbz.curve_pair_min_distance(_t(a), _t(b))
    assert abs(float(dist) - 1.0) <= 1e-9


def test_continuous_safety_ratio_matches(rng):
    """tests/test_aux.py's continuous audit case (4 agents, 5 segments,
    continuous across segments): equal to JAX's, and a lower bound of a
    dense sampled audit, tight to 1e-3."""
    N, M, n = 4, 5, 5
    base = rng.normal(size=(N, 1, 1, 3)) * 3.0
    trajs = base + rng.normal(size=(N, M, n + 1, 3)) * 0.5
    trajs[:, 1:, 0] = trajs[:, :-1, -1]
    radius = rng.uniform(0.1, 0.3, size=N)
    downwash = rng.uniform(1.0, 2.0, size=N)
    got = taudit.continuous_safety_ratio(_t(trajs), _t(radius), _t(downwash))
    want = jaudit.continuous_safety_ratio(jnp.asarray(trajs),
                                          jnp.asarray(radius),
                                          jnp.asarray(downwash))
    assert got.shape == ()
    _close(got, want)
    ts = np.linspace(0, 1, 2001)
    pos = np.asarray(jax.vmap(lambda t: jbz.bernstein_eval(
        jnp.asarray(trajs), t))(jnp.asarray(ts)))          # (T, N, M, 3)
    r_sum = radius[:, None] + radius[None, :]
    dw = (downwash[:, None] * radius[:, None] +
          downwash[None, :] * radius[None, :]) / r_sum
    delta = pos[:, :, None] - pos[:, None]
    dist = np.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2 +
                   (delta[..., 2] / dw[None, :, :, None]) ** 2)
    ratio = dist / r_sum[None, :, :, None]
    ratio[:, np.arange(N), np.arange(N)] = np.inf
    sampled = float(ratio.min())
    assert sampled - 1e-3 <= float(got) <= sampled + 1e-9


# --------------------------------------------------- logging and replay
def test_logging_and_replay_roundtrip(tmp_path):
    """tests/test_aux.py's 4-agent mission (f64): the JAX package's run,
    cycle by cycle, logged by both packages' loggers from the same states,
    gives CSVs that compare_runs puts within 1e-5 m; the port's own run
    with run(log=...) replays with the mission's starts and writes its
    summary row.  (The two packages' free runs of this mission part after
    cycle 12, each port cycle from JAX's state within 1e-10 m: ROADMAP,
    divergences.)"""
    jp, tp = params(qp_iterations=10)
    jm, tm = missions("make_circle_mission", 4, radius=2.0,
                      world=(-4, -4, 0, 4, 4, 2.5))
    jsim = JSim(jm, jp, dtype=jnp.float64)
    sim = TSim(tm, tp, dtype=torch.float64)
    jlog = JLogger(str(tmp_path / "jax"), jsim.param, jm.qn)
    tlog = ResultLogger(str(tmp_path / "follow"), sim.param, tm.qn)
    js = jsim.initial_state()
    for it in range(60):
        js, _ = jsim._cycle_jit(js)
        jlog.record_cycle(jsim, js, 0.01)
        tlog.record_cycle(sim, port_state(js), 0.01)
        if jsim.is_finished(js):
            break
    got, want = read_result_csv(tlog.path), read_result_csv(jlog.path)
    assert len(got.t) == len(want.t) == 2 * (it + 1)
    assert compare_runs(got, want)["max_pos_err"] <= 1e-5
    np.testing.assert_array_equal(got.t, want.t)

    log = ResultLogger(str(tmp_path / "port"), sim.param, tm.qn)
    summary = sim.run(max_iterations=60, log=log)
    path = append_summary(str(tmp_path / "port"), sim.param, tm.qn, summary,
                          mission_file="circle4")
    data = read_result_csv(log.path)
    assert data.qn == 4 and len(data.t) == 2 * summary["iterations"]
    np.testing.assert_allclose(
        data.pos[0], np.stack([a.start for a in tm.agents]), atol=1e-5)
    assert compare_runs(data, data)["max_pos_err"] == 0.0
    with open(path) as f:
        lines = f.read().strip().splitlines()
    assert lines[0].startswith("start_time,total_flight_time")
    assert len(lines) == 2


def test_logging_with_dynamic_obstacles(tmp_path):
    """A run with two dynamic obstacles logs their rows after the agents'
    (obs_id blocks), read back by the replay."""
    from lsc_planner_tpu_torch.missions import ObstacleSpec
    m = make_circle_mission(3, radius=2.0, world=(-4, -4, 0, 4, 4, 2.5))
    m.obstacles = [ObstacleSpec(kind="straight", size=0.3, max_acc=1.0,
                                downwash=1.0, start=np.array(s),
                                goal=np.array(g), speed=0.3)
                   for s, g in (([-3.0, 0, 1], [3.0, 0, 1]),
                                ([0, -3.0, 1], [0, 3.0, 1]))]
    sim = TSim(m, Param(qp_iterations=10), dtype=torch.float64)
    log = ResultLogger(str(tmp_path), sim.param, m.qn, sim.O_dyn)
    sim.run(max_iterations=5, log=log)
    data = read_result_csv(log.path)
    assert data.obs_pos.shape == (len(data.t), 2, 3)
    np.testing.assert_allclose(data.obs_radius, [0.3, 0.3])
    assert np.abs(data.obs_pos[-1, 0, 0] + 3.0) > 0.1     # moved


# ------------------------------------------------ command sampler, msgs
def test_command_sampler():
    """tests/test_aux.py's command sampler case."""
    p = Param()
    cs = CommandSampler(p)
    traj = np.zeros((2, p.M, p.n + 1, 3))
    traj[0, :, :, 0] = np.linspace(0, 1, p.M * (p.n + 1)).reshape(
        p.M, p.n + 1)
    cs.push(0.0, traj)
    out = cs.sample(0.1)
    assert out["pos"].shape == (2, 3)
    assert 0.0 < out["pos"][0, 0] < 1.0
    cs.push(0.2, torch.ones(traj.shape, dtype=torch.float64))
    out2 = cs.sample(0.25)
    np.testing.assert_allclose(out2["pos"][0], [1, 1, 1], atol=1e-6)
    assert len(cs.run_span(0.3, 0.39)) == 5


def test_msgs_roundtrips(rng, tmp_path):
    """tests/test_msgs.py's round trips through the port's copy."""
    trajs = rng.normal(size=(4, 5, 6, 3))
    arr = msgs.TrajectoryArray.from_swarm(7, trajs, 0.2)
    assert arr.trajectories[0].M == 5 and arr.trajectories[0].n == 5
    path = str(tmp_path / "trajs.json")
    msgs.dump_json(arr, path)
    back = msgs.load_json(msgs.TrajectoryArray, path)
    np.testing.assert_allclose(back.to_array(), trajs, atol=1e-12)
    assert back.planner_seq == 7
    st = msgs.State(id=3, planner_seq=11, pos=[1, 2, 3], vel=[0, 0, 0],
                    acc=[0, 0, 0])
    assert msgs.State.from_dict(st.to_dict()) == st
    oa = msgs.ObstacleArray(start_time=1.5, obstacles=[
        msgs.Obstacle(id=0, type="agent", pos=[0, 0, 1], vel=[1, 0, 0],
                      goal_point=[5, 0, 1], radius=0.15, downwash=2.0)])
    msgs.dump_json(oa, str(tmp_path / "obs.json"))
    assert msgs.load_json(msgs.ObstacleArray,
                          str(tmp_path / "obs.json")) == oa
    C, M, n1 = 2, 5, 6
    obs_pred = rng.normal(size=(C, M, n1, 3))
    boxes = rng.normal(size=(M, 6))
    msg = msgs.CollisionConstraint.from_planes(
        4, 1, obs_pred, rng.normal(size=(C, M, 3)),
        rng.normal(size=(C, M, n1)), boxes)
    d2 = msgs.CollisionConstraint.from_dict(msg.to_dict())
    np.testing.assert_allclose(d2.rsfcs[1][2]["obs_control_points"],
                               obs_pred[1, 2], atol=1e-12)
    np.testing.assert_allclose(d2.sfcs[3]["box_min"], boxes[3, :3],
                               atol=1e-12)


LP_TEXT = """\\ a small QP in the reference's export format
Minimize
 obj: 2 x_0_0 - 3 y_0_1 + 1.5 + [ 4 x_0_0 ^2 + 2 x_0_0 * x_0_1
 + 6 z_0_1 ^2 ] / 2
Subject To
 c1: x_0_0 + x_0_1 = 1
 c2: y_0_0 - 2 z_0_0 >= -0.5
 c3: 3 z_0_1 <= 2
Bounds
 x_0_0 Free
 -1 <= y_0_0 <= 4
End
"""


def test_lpfile_parses(tmp_path):
    """An LP text in the reference's export subset (M = 1, n = 1: six
    variables): the objective's linear, constant and quadratic parts, the
    three row kinds and the bounds; the JAX package's reader gives the
    same arrays."""
    path = tmp_path / "model.lp"
    path.write_text(LP_TEXT)
    m = tlp.parse_lp(str(path), M=1, n=1)
    x00, x01, y00, y01, z00, z01 = range(6)
    q = np.zeros(6)
    q[x00], q[y01] = 2.0, -3.0
    np.testing.assert_array_equal(m.q, q)
    assert m.c == 1.5
    P = np.zeros((6, 6))
    P[x00, x00], P[z01, z01] = 4.0, 6.0
    P[x00, x01] = P[x01, x00] = 1.0
    np.testing.assert_array_equal(m.P, P)
    np.testing.assert_array_equal(m.A_eq, [[1, 1, 0, 0, 0, 0]])
    np.testing.assert_array_equal(m.b_eq, [1.0])
    np.testing.assert_array_equal(m.A_in, [[0, 0, 1, 0, -2, 0],
                                           [0, 0, 0, 0, 0, -3]])
    np.testing.assert_array_equal(m.b_in, [-0.5, -2.0])
    assert m.lo[y00] == -1 and m.hi[y00] == 4 and np.isinf(m.lo[x00])
    rows, rhs = tlp.bounds_as_rows(m)
    np.testing.assert_array_equal(rhs, [-1.0, -4.0])
    want = jlp.parse_lp(str(path), M=1, n=1)
    for a, b in zip(m, want):
        np.testing.assert_array_equal(a, b)


def test_debug_recorder_dumps(tmp_path):
    """Frames of tensors are saved, loaded back, and the LSC feasibility
    check reports a violated row."""
    dbg = DebugRecorder(str(tmp_path), agent_id=1)
    init = torch.zeros((2, 5, 6, 3), dtype=torch.float64)
    normal = torch.zeros((2, 1, 5, 3), dtype=torch.float64)
    normal[..., 0] = 1.0
    rhs = torch.zeros((2, 1, 5, 6), dtype=torch.float64)
    rhs[1, 0, 2, 3] = 0.5
    dbg.record(4, init, init[:, None], normal, rhs, init,
               torch.ones(2), torch.zeros(2))
    frames = DebugRecorder.load(dbg.save())
    assert frames[0]["lsc_normal"].shape == (1, 1, 5, 3)
    report = dbg.check_lsc_feasibility()
    assert report["worst"] == -0.5
    np.testing.assert_array_equal(report["violations"], [[0, 0, 2, 3]])


# --------------------------------------------------- stage profiles, CLI
def test_profile_stages_keys_match_jax():
    """profile_stages gives the JAX package's stage keys, each a time;
    run(profile=True) returns them in stage_times (several cycles a
    dispatch too), and the ORCA planner's stay empty as in JAX."""
    jp, tp = params(qp_iterations=8)
    jm, tm = missions("make_circle_mission", 4, radius=2.0,
                      world=(-4, -4, 0, 4, 4, 2.5))
    jsim = JSim(jm, jp, dtype=jnp.float64)
    want = jsim.profile_stages(jsim.initial_state(), n_cycles=1)
    sim = TSim(tm, tp, dtype=torch.float64)
    got = sim.profile_stages(sim.initial_state(), n_cycles=1)
    assert list(got) == list(want)
    assert all(v >= 0.0 for v in got.values())
    for k in (1, 2):
        summary = sim.run(max_iterations=2, profile=True,
                          steps_per_dispatch=k)
        assert list(summary["stage_times"]) == list(want)
    orca = TSim(tm, Param(planner_mode=PlannerMode.ORCA,
                          goal_mode=GoalMode.STATIC), dtype=torch.float64)
    assert orca.run(max_iterations=2, profile=True)["stage_times"] == {}


def test_cli_generate_run_replay(tmp_path, capsys):
    """tests/test_aux.py's CLI case on the CPU, with the result CSV saved
    and replayed; without --device the CLI asks for the card."""
    out = str(tmp_path / "m.json")
    assert cli.main(["--generate", "circle:4", "--out", out]) == 0
    assert load_mission(out).qn == 4
    logs = str(tmp_path / "log")
    assert cli.main(["--mission", out, "--max-iterations", "3",
                     "--dtype", "float64", "--device", "cpu",
                     "--set", "qp_iterations=8", "--save-result",
                     "--log-dir", logs]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["iterations"] == 3 and not summary["is_collided"]
    (csv,) = [f for f in os.listdir(logs) if f.startswith("result_")]
    assert cli.main(["--replay", os.path.join(logs, csv)]) == 0
    replay = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert replay["agents"] == 4 and replay["rows"] == 3 * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--mission", out, "--max-iterations", "1"])
