"""Port parity: the other planner modes (BVC and reciprocal RSFC
planes, the right-hand goal rule, the 2-D layout); the slack-relaxed QP
and experiment mode are test_torch_slack.py's.

Stated tolerances (float64 on both sides unless named): the planes,
geometry, size prediction and goal rule within 1e-9; a 2-D
TrajOptimizer.solve within 1e-8 m (trajectories; the cost within rtol
1e-6, since the jerk cost's gradient is ~1e4 per m); the fused IPM's plain
2-D version in float32 against the JAX package's fused kernel in
interpret mode with tests/test_optimizer.py:211's tolerance (objective
rtol 1e-3, atol 1e-5, primal residual < 1e-4).  Whole missions in these
modes are test_torch_mode_missions.py's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu.config import GoalMode
from lsc_planner_tpu.ops import geometry as jgeo
from lsc_planner_tpu.ops import qp as jqp
from lsc_planner_tpu.planner import constraints as jcons
from lsc_planner_tpu.planner import goal as jgoal
from lsc_planner_tpu.planner import optimizer as jopt
from lsc_planner_tpu.planner import prediction as jpred
from lsc_planner_tpu_torch.ops import geometry as tgeo
from lsc_planner_tpu_torch.ops import qp as tqp
from lsc_planner_tpu_torch.planner import constraints as tcons
from lsc_planner_tpu_torch.planner import goal as tgoal
from lsc_planner_tpu_torch.planner import optimizer as topt
from lsc_planner_tpu_torch.planner import prediction as tpred
from torch_parity import missions, params, torch_one_thread  # noqa: F401

TOL = 1e-9
SOLVE_TOL = 1e-8
COST_RTOL = 1e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= tol


def _swarm(rng, N=6, M=5, n1=6):
    """Trajectories of a small swarm around a circle, a few near-touching
    (test_torch_planner.py's)."""
    th = np.linspace(0, 2 * np.pi, N, endpoint=False)
    start = np.stack([2 * np.cos(th), 2 * np.sin(th), np.ones(N)], -1)
    drift = rng.normal(size=(N, 1, 1, 3)) * 0.4
    tau = np.linspace(0, 1, M * n1).reshape(1, M, n1, 1)
    return start[:, None, None] + drift * tau + \
        rng.normal(size=(N, M, n1, 3)) * 0.02


def _obstacle_view(rng, traj):
    """Every agent's view of the others plus two non-agent obstacles:
    (obs_pred, obs_radius, obs_downwash, obs_is_agent, obs_mask)."""
    N = traj.shape[0]
    extra = traj[:2] + rng.normal(size=(2, 1, 1, 3)) * 0.5
    obs = np.concatenate([traj, extra])
    O = obs.shape[0]
    obs_pred = np.broadcast_to(obs[None], (N,) + obs.shape)
    radius = np.concatenate([np.full(N, 0.15), [0.3, 0.25]])
    downwash = np.concatenate([rng.uniform(1.5, 2.5, size=N), [1.0, 1.0]])
    is_agent = np.concatenate([np.ones(N, bool), np.zeros(2, bool)])
    mask = np.ones((N, O), bool)
    mask[np.arange(N), np.arange(N)] = False
    return (obs_pred, np.broadcast_to(radius[None], (N, O)),
            np.broadcast_to(downwash[None], (N, O)),
            np.broadcast_to(is_agent[None], (N, O)), mask)


# ------------------------------------------------------- geometry, sizes
def test_normal_vector_between_paths_matches(rng):
    """Random linear paths, paths that touch mid-way (the (b - a) x z
    heuristic), and touching paths moving along z (the x fallback)."""
    a0, a1, o0, o1 = (rng.normal(size=(64, 3)) for _ in range(4))
    cross = 0.5 * (a0 + a1)                     # the obstacle passes it
    o0[:16] = cross[:16] - (a1[:16] - a0[:16]) * 0.5 + \
        np.array([0.3, -0.2, 0.0])
    o1[:16] = cross[:16] + (a1[:16] - a0[:16]) * 0.5 - \
        np.array([0.3, -0.2, 0.0])
    o0[16:24], o1[16:24] = a0[16:24], a1[16:24]   # on top of each other
    a1[24:32] = a0[24:32] + np.array([0.0, 0.0, 1.0])
    o0[24:32] = a0[24:32] - np.array([0.0, 0.0, 0.5])
    o1[24:32] = o0[24:32] + np.array([0.0, 0.0, 3.0])
    args = (o0, o1, a0, a1)
    j = jgeo.normal_vector_between_paths(*map(jnp.asarray, args))
    t = tgeo.normal_vector_between_paths(*map(_t, args))
    for a, b in zip(t, j):
        _close(a, b)
    jc = jgeo.closest_between_linear_paths(*map(jnp.asarray, args))
    tc = tgeo.closest_between_linear_paths(*map(_t, args))
    for a, b in zip(tc, jc):
        _close(a, b)
    # the touching cases took the heuristics
    assert (t[1][16:24] < 1e-12).all()
    np.testing.assert_allclose(t[0][24:32].numpy(),
                               np.tile([1.0, 0.0, 0.0], (8, 1)))


@pytest.mark.parametrize("size_prediction", [True, False])
def test_obstacle_size_prediction_matches(rng, size_prediction):
    radius = rng.uniform(0.1, 0.4, size=(4, 7))
    max_acc = rng.uniform(0.5, 3.0, size=(4, 7))
    for horizon in (0.5, 1.0, 2.0):
        j = jpred.obstacle_size_prediction(
            jnp.asarray(radius), jnp.asarray(max_acc), 5, 5, 0.2, horizon,
            size_prediction)
        t = tpred.obstacle_size_prediction(_t(radius), _t(max_acc), 5, 5,
                                           0.2, horizon, size_prediction)
        _close(t, j)


# ----------------------------------------------------------------- planes
def test_bvc_and_rsfc_planes_match(rng):
    traj = _swarm(rng)
    N = traj.shape[0]
    radius = np.full(N, 0.15)
    downwash = rng.uniform(1.5, 2.5, size=N)
    obs_pred, o_r, o_dw, o_agent, o_mask = _obstacle_view(rng, traj)
    j = jcons.bvc_planes(*map(jnp.asarray, (traj, obs_pred, radius,
                                            downwash, o_r, o_dw, o_agent,
                                            o_mask)))
    t = tcons.bvc_planes(*map(_t, (traj, obs_pred, radius, downwash, o_r,
                                   o_dw, o_agent, o_mask)))
    for a, b in zip(t, j):
        _close(a, b)
    sizes = np.asarray(jpred.obstacle_size_prediction(
        jnp.asarray(o_r), jnp.full(o_r.shape, 2.0), 5, 5, 0.2, 1.0))
    args = (traj, obs_pred, sizes, radius, downwash, o_r, o_dw, o_agent,
            o_mask)
    j = jcons.rsfc_planes(*map(jnp.asarray, args))
    t = tcons.rsfc_planes(*map(_t, args))
    for a, b in zip(t, j):
        _close(a, b)


def test_right_hand_goal_matches(rng):
    """Deadlocked agents (late, slow, far from the goal) turn right."""
    jp, tp = params(goal_mode=GoalMode.RIGHT_HAND)
    jm, tm = missions("make_circle_mission", 6)
    pos = rng.normal(size=(6, 3))
    vel = rng.normal(size=(6, 3)) * np.array([1, 1, 1, 0.001, 0.001,
                                              0.001])[:, None]
    goal = pos + rng.normal(size=(6, 3))
    goal[2] = pos[2] + 0.01                            # at its goal
    traj = np.broadcast_to(pos[:, None, None], (6, 5, 6, 3))
    for seq in (3, 50):
        kw = dict(pos=pos, vel=vel, init_traj=traj, desired_goal=goal,
                  seq=np.int32(seq), radius=np.full(6, 0.15),
                  downwash=np.full(6, 2.0))
        j = jgoal.GoalPlanner(jm, jp).plan(
            **{k: jnp.asarray(v) for k, v in kw.items()})
        t = tgoal.GoalPlanner(tm, tp).plan(**{k: _t(v)
                                              for k, v in kw.items()})
        for a, b in zip(t, j):
            _close(a, b)
        moved = (t[0].numpy() != goal).any(-1)
        assert moved.tolist() == ([False] * 6 if seq == 3 else
                                  [False, False, False, True, True, True])


# ------------------------------------------------------------ the solves
def _solve_inputs(rng, N, C, dim=3, cut=True):
    """Inputs of TrajOptimizer.solve: a swarm near z = 0.7 heading for
    goals 1.6 m away, C planes of random normals 0.5-1 m from the start
    (plane 0 cutting into the way with `cut`), planar (in-plane normals,
    z = z0 held) when dim == 2."""
    pos = np.concatenate([rng.normal(size=(N, 2)), np.full((N, 1), 0.7)],
                         axis=1)
    vel = np.zeros((N, 3))
    vel[:, :dim] = rng.normal(size=(N, dim)) * 0.1
    acc = np.zeros((N, 3))
    goal = pos + np.array([1.5, 0.5, 0.0])
    normal = rng.normal(size=(N, C, 5, 3))
    if dim == 2:
        normal[..., 2] = 0.0
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    rhs = np.einsum("ncmk,nk->ncm", normal, pos)[..., None] - \
        rng.uniform(0.5, 1.0, size=(N, C, 5, 1))
    rhs = np.broadcast_to(rhs, (N, C, 5, 6)).copy()
    if cut:
        rhs[:, 0, 1:] += 0.9       # plane 0 cuts into the way: slack
    mask = np.ones((N, C, 5), bool)
    return pos, vel, acc, goal, normal, rhs, mask


def _solve_both(jp, tp, inputs, jslack=None, tslack=None, max_vel=1.0):
    pos, vel, acc, goal, normal, rhs, mask = inputs
    N = pos.shape[0]
    common = dict(nominal_velocity=np.ones(N),
                  max_vel=np.full((N, 3), max_vel),
                  max_acc=2 * np.ones((N, 3)),
                  world_min=np.array([-50, -50, 0.0]),
                  world_max=np.array([50, 50, 2.5]))
    j = jopt.TrajOptimizer(jp).solve(
        *map(jnp.asarray, (pos, vel, acc, goal)),
        planes=jopt.PlaneConstraints(*map(jnp.asarray, (normal, rhs, mask))),
        **{k: jnp.asarray(v) for k, v in common.items()},
        slack=jslack, dtype=jnp.float64)
    t = topt.TrajOptimizer(tp).solve(
        *map(_t, (pos, vel, acc, goal)),
        planes=topt.PlaneConstraints(*map(_t, (normal, rhs, mask))),
        **{k: _t(v) for k, v in common.items()},
        slack=tslack, dtype=torch.float64)
    return j, t


def test_2d_layout_solve_matches(rng):
    """tests/test_optimizer.py:169's planar solve: nv = 2 nf, z held at
    z0 = 0.7 exactly, and the JAX package's trajectories."""
    jp, tp = params(world_dimension=2, world_z_2d=0.7)
    topt_ = topt.TrajOptimizer(tp)
    assert topt_.dim == 2 and topt_.nv == 2 * topt_.nf
    np.testing.assert_array_equal(topt_.static_blocked[0],
                                  jopt.TrajOptimizer(jp).static_blocked[0])
    j, t = _solve_both(jp, tp, _solve_inputs(rng, 4, 3, dim=2))
    _close(t.traj, j.traj, SOLVE_TOL)
    np.testing.assert_allclose(t.cost.numpy(), np.asarray(j.cost),
                               rtol=COST_RTOL)
    np.testing.assert_allclose(t.traj[..., 2].numpy(), 0.7, atol=1e-12)


def test_fused_plain_2d_matches_jax(rng):
    """tests/test_optimizer.py:211 on both packages: the fused IPM at ndim
    2, the JAX package's Pallas kernel in interpret mode against the
    port's plain version (fused_mode "on" on a CPU tensor), float32."""
    jp, tp = params(world_dimension=2)
    to2 = jopt.TrajOptimizer(jp)
    A_st = to2.A_static_y
    nv, nf = to2.nv, to2.nf
    N, C, M, n1 = 3, 4, to2.M, to2.n + 1
    Lb = rng.normal(size=(N, nf, nf)) * 0.3
    P_blk = (Lb @ np.swapaxes(Lb, -1, -2) +
             2.0 * np.eye(nf)).astype(np.float32)
    P = np.zeros((N, nv, nv), np.float32)
    for k in range(2):
        P[:, k * nf:(k + 1) * nf, k * nf:(k + 1) * nf] = P_blk
    q = rng.normal(size=(N, nv)).astype(np.float32)
    F_seg = to2.F_seg.astype(np.float32)
    b_st = (rng.normal(size=(N, A_st.shape[0])) - 5.0).astype(np.float32)
    normal = rng.normal(size=(N, C, M, 2)).astype(np.float32)
    rhs = (rng.normal(size=(N, C, M, n1)) - 3.0).astype(np.float32)
    mask = rng.uniform(size=(N, C, M, n1)) > 0.3
    y0 = rng.normal(size=(N, nv)).astype(np.float32) * 0.1
    common = [P, q, A_st, b_st, normal, rhs, mask, F_seg]
    j = jqp.solve_qp_lsc(*map(jnp.asarray, common), y0=jnp.asarray(y0),
                         iters=15, static_blocks=to2.static_blocked,
                         tol_gap=0.0, tol_rp=0.0, P_blk=jnp.asarray(P_blk),
                         fused_mode="interpret")
    t32 = [torch.as_tensor(a) for a in common]
    t32[2] = t32[2].float()
    t = tqp.solve_qp_lsc(*t32, y0=_t(y0), iters=15,
                         static_blocks=topt.TrajOptimizer(
                             tp).static_blocked_on(torch.float32,
                                                   torch.device("cpu")),
                         tol_gap=0.0, tol_rp=0.0, P_blk=_t(P_blk),
                         fused_mode="on")
    assert t.y.shape == (N, nv) and t.y.dtype == torch.float32
    np.testing.assert_allclose(t.obj.numpy(), np.asarray(j.obj), rtol=1e-3,
                               atol=1e-5)
    assert float(t.primal_res.max()) < 1e-4
