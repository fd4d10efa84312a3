"""Port parity: the slack-relaxed QP, RSFC missions and experiment mode.

Stated tolerances (float64 on both sides): the disturbance gates exact,
slack-marked LSC planes within 1e-9; a slack-relaxed TrajOptimizer.solve
within 1e-8 m (trajectories, slacks; the cost within rtol 1e-6) at a
slack weight of 100 and within 1e-4 m at Param's 1e5 (see
test_slack_solve_matches); inject_positions exact; experiment-mode
missions with an injected disturbance: at every cycle of the JAX
package's mission the port's cycle from JAX's state within 1e-6 m of
JAX's, and, flown alone, the same cycle count.  The RSFC missions are
test_torch_mode_missions.py's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.config import GoalMode
from lsc_planner_tpu.planner import constraints as jcons
from lsc_planner_tpu.planner import optimizer as jopt
from lsc_planner_tpu.planner import prediction as jpred
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch.planner import constraints as tcons
from lsc_planner_tpu_torch.planner import optimizer as topt
from lsc_planner_tpu_torch.planner import prediction as tpred
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim
from test_torch_modes import (SOLVE_TOL, COST_RTOL, _close, _obstacle_view,
                              _solve_both, _solve_inputs, _swarm, _t)
from torch_parity import (fly_alone, follow_jax, missions, params,  # noqa
                          port_state, straight_obstacles, torch_one_thread)

CYCLE_TOL = 1e-6


def test_disturbance_gates_match(rng):
    pred = rng.normal(size=(3, 5, 5, 6, 3))
    obs_pos = pred[..., 0, 0, :] + rng.normal(size=(3, 5, 3)) * 0.3
    j = jpred.prediction_check(jnp.asarray(pred), jnp.asarray(obs_pos), 0.3)
    t = tpred.prediction_check(_t(pred), _t(obs_pos), 0.3)
    for a, b in zip(t, j):
        _close(a, b, 0.0)
    assert 0 < int(t[1].sum()) < t[1].numel()
    init = pred[0]
    pos = init[:, 0, 0, :] + rng.normal(size=(5, 3)) * 0.3
    j = jpred.initial_traj_check(jnp.asarray(init), jnp.asarray(pos), 0.3)
    t = tpred.initial_traj_check(_t(init), _t(pos), 0.3)
    for a, b in zip(t, j):
        _close(a, b, 0.0)


@pytest.mark.parametrize("guard", [0.0, 0.004])
def test_lsc_planes_with_slack_match(rng, guard):
    """Slack-flagged non-agent obstacles take the RSFC margin."""
    traj = _swarm(rng)
    N = traj.shape[0]
    radius = np.full(N, 0.15)
    downwash = rng.uniform(1.5, 2.5, size=N)
    obs_pred, o_r, o_dw, o_agent, o_mask = _obstacle_view(rng, traj)
    flags = (rng.uniform(size=o_mask.shape) > 0.5) & o_mask
    flags[:, -2:] = True
    sizes = np.asarray(jpred.obstacle_size_prediction(
        jnp.asarray(o_r), jnp.full(o_r.shape, 1.5), 5, 5, 0.2, 1.0))
    args = (traj, obs_pred, radius, downwash, o_r, o_dw, o_agent, o_mask)
    j = jcons.lsc_planes(*map(jnp.asarray, args),
                         slack_flags=jnp.asarray(flags),
                         obs_pred_sizes=jnp.asarray(sizes),
                         guard_margin=guard)
    t = tcons.lsc_planes(*map(_t, args), slack_flags=_t(flags),
                         obs_pred_sizes=_t(sizes), guard_margin=guard)
    for a, b in zip(t, j):
        _close(a, b)
    plain = tcons.lsc_planes(*map(_t, args), guard_margin=guard)
    assert not torch.equal(plain.rhs[:, -2:], t.rhs[:, -2:])


@pytest.mark.parametrize("mode", ["collision", "dynamical"])
def test_slack_solve_matches(rng, mode):
    """The dense slack extension: a collision SlackSpec on the 4 planes
    (its enable mask random, S = 20, n = 59) or a dynamical one (S = 2 M
    = 10, n = 49; no plane in the way, the agents at 0.9 m/s against a
    limit of 0.4), through TrajOptimizer.solve.  (With fewer slack
    entries than planes, as an SFC's faces would add, the JAX package's
    take_along_axis fills the extra rows' enable with NaN and the whole
    QP with it; the port gives those rows no slack.)  The slack weight is
    100: at Param's 1e5 the KKT system's conditioning amplifies the two
    packages' summation orders to 1e-5 m after 20 iterations (2e-5 after
    40), so there the trajectories are held to 1e-4 m."""
    N, C = 4, 4
    jp, tp = params(qp_iterations=20)
    inputs = _solve_inputs(rng, N, C, cut=mode == "collision")
    vmax = 1.0 if mode == "collision" else 0.4
    if mode == "dynamical":
        inputs = (inputs[0], np.tile([0.9, 0.0, 0.0], (N, 1))) + inputs[2:]
    enable = rng.uniform(size=(N, C)) > 0.3
    enable[:, 0] = True

    def specs(w):
        if mode == "collision":
            return (jopt.SlackSpec("collision", enable=jnp.asarray(enable),
                                   n_slack_c=C, weight=w),
                    topt.SlackSpec("collision", enable=_t(enable),
                                   n_slack_c=C, weight=w))
        return (jopt.SlackSpec("dynamical", weight=w),
                topt.SlackSpec("dynamical", weight=w))
    j, t = _solve_both(jp, tp, inputs, *specs(tp.slack_collision_weight),
                       max_vel=vmax)
    _close(t.traj, j.traj, 1e-4)
    js, ts = specs(100.0)
    j, t = _solve_both(jp, tp, inputs, js, ts, max_vel=vmax)
    assert t.slack.shape == (N, 5 * C if mode == "collision" else 10)
    _close(t.traj, j.traj, SOLVE_TOL)
    _close(t.slack, j.slack, SOLVE_TOL)
    np.testing.assert_allclose(t.cost.numpy(), np.asarray(j.cost),
                               rtol=COST_RTOL)
    _close(t.primal_res, j.primal_res, SOLVE_TOL)
    assert float(t.primal_res.max()) < 1e-6
    assert (t.slack.numpy() < -1e-6).any()         # the slacks took part
    if mode == "collision":
        fewer = topt.SlackSpec(
            "collision", enable=_t(enable[:, :3]), n_slack_c=3,
            weight=tp.slack_collision_weight)
        t3 = _solve_both(jp, tp, inputs, js, fewer)[1]
        assert torch.isfinite(t3.traj).all() and t3.slack.shape == (N, 15)


# ------------------------------------------------------------- missions
def _exp_sims(obstacle):
    """tests/test_disturbance.py's experiment mission (4-agent square,
    PRIOR_BASED, qp_iterations 20), optionally with a straight obstacle
    crossing it."""
    jp, tp = params(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=20,
                    multisim_experiment=True)
    jm, tm = missions("make_square_mission", 4)
    if obstacle:
        jm, tm = straight_obstacles(jm, tm, [((-4.0, -0.5, 1.0),
                                           (4.0, -0.5, 1.0))])
    return (JSim(jm, jp, dtype=jnp.float64),
            TSim(tm, tp, device="cpu", dtype=torch.float64))


PUSH = np.array([0.3, 0.3, 0.0])       # agent 0, before cycle 5


@pytest.mark.parametrize("obstacle", [False, True])
def test_experiment_mission_matches_jax(obstacle):
    """A disturbance injected before cycle 5 (agent 0 observed 0.42 m off
    its plan, as tests/test_disturbance.py pushes it): inject_positions
    equals JAX's; the next cycle is the slack QP with the RSFC margin for a
    slack-flagged obstacle, and it clears the flags; then to the finish.
    With the obstacle its rows carry zero flags (JAX simulator.py:704-709)."""
    jsim, tsim = _exp_sims(obstacle)
    dt = tsim.param.multisim_time_step

    def dyn(it):
        if not obstacle:
            return ()
        dp, dv = tsim.obstacle_generator.update(it * dt)
        return dp.copy(), dv.copy()

    def inject(it, js):
        if it != 5:
            return js
        real = np.array(jsim.propagate(js)[0])
        real[0] += PUSH
        jnew = jsim.inject_positions(js, real)
        tnew = tsim.inject_positions(port_state(js), real)
        for k, a in jnew._asdict().items():
            b = getattr(tnew, k)
            if a is None:
                assert b is None, k
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=k)
        assert tnew.slack_flags.tolist() == [True, False, False, False]
        after, info = tsim.cycle(tnew, *[torch.as_tensor(a)
                                         for a in dyn(it)])
        assert not after.slack_flags.any()
        assert torch.isfinite(after.traj).all()
        assert float(info.primal_res.max()) < 0.1
        return jnew
    errs, jdone, _ = follow_jax(jsim, tsim, 80, dyn=dyn, before=inject)
    assert jdone is not None
    assert errs.max() <= CYCLE_TOL, (errs.argmax(), errs.max())

    def step(it, s):
        if it == 5:
            real = tsim.propagate(s)[0].numpy().copy()
            real[0] += PUSH
            s = tsim.inject_positions(s, real)
        return tsim.cycle(s, *[torch.as_tensor(a) for a in dyn(it)])
    tdone, ts = fly_alone(tsim, 80, step)
    assert tdone == jdone


def test_several_cycles_a_dispatch_refuse_experiment_mode():
    """As the JAX package (simulator.py:1252-1258): experiment mode paces
    itself to real time and takes external poses, so run() refuses to
    dispatch several cycles at once."""
    _, tsim = _exp_sims(False)
    with pytest.raises(ValueError, match="experiment"):
        tsim.run(max_iterations=8, steps_per_dispatch=4)
