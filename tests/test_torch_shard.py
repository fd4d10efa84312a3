"""Port parity: the multi-GPU layer (parallel/shard.py on torch.distributed)
against the JAX package's shard_map cycle.

The JAX side runs on the conftest's virtual 8-device CPU mesh; the port's
ranks are processes of parallel.launch.spawn_ranks on the gloo backend with
device="cpu".  Every case of one world size runs in one spawn (a
module-scoped fixture).  As in the JAX package's own tests, f64 with the
QP's exit tests off (qp_tol_gap = qp_tol_rp = 0): the exit test is
batch-global, so a rank's block and the whole swarm could stop at other
iterations.  Stated tolerances: the all_gather and 2-axis all_gather
cycles within 1e-8 m of JAX's (safety 1e-8, distance 1e-7); the halo cycles
within 1e-7 m (the halo view's row order differs from the all_gather
view's); the sorted lane cycles within 1e-8 m; Morton codes and sort
permutations equal.
"""
import datetime
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lsc_planner_tpu.config import GoalMode
from lsc_planner_tpu.parallel import shard as jshard
from lsc_planner_tpu.sim.simulator import SyncSimulator as JSim
from lsc_planner_tpu_torch.convert import state_to_numpy
from lsc_planner_tpu_torch.parallel import ranks, shard
from lsc_planner_tpu_torch.parallel.launch import spawn_ranks
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator as TSim
from torch_parity import (missions, params, port_state,  # noqa: F401
                          torch_one_thread)

EXACT = dict(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=14,
             qp_tol_gap=0.0, qp_tol_rp=0.0)
LANE = dict(EXACT, max_neighbors=4)
F64 = torch.float64


def _call(fn, *args, **kwargs):
    return (fn, args, kwargs)


def _same_on_every_rank(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])


def _jax_cycles(jsim, mesh, cycles, halo=None, sort=None):
    """JAX's sharded cycle on the global state: the trajectories after each
    cycle, and the last state."""
    cyc = jshard.make_sharded_cycle(jsim, mesh, halo_shards=halo)
    state = jshard.shard_state(jsim.initial_state(), mesh)
    trajs = []
    for _ in range(cycles):
        if sort is not None:
            state = sort(state)
        state, _ = cyc(state)
        trajs.append(np.asarray(state.traj))
    return trajs, state


def _lane_sort(jsim):
    wmin, wmax = jsim.mission.world_min, jsim.mission.world_max
    return jax.jit(lambda s: jshard.spatial_sort_state(s, wmin, wmax,
                                                       key="axis:1"))


# ------------------------------------------------------------ the spawns
@pytest.fixture(scope="module")
def world4():
    """4 ranks: the 16-agent circle by all_gather; lanes16 (H = 1, axis
    sort) for 3 cycles and then through run(cycle_fn=...) to the finish;
    dry-run part (d) on 4 hosts of one chip."""
    _, tm16 = missions("make_circle_mission", 16, radius=4.0)
    _, tlanes = missions("make_lane_mission", 16, lane_gap=2.0, length=6.0)
    _, tp = params(**EXACT)
    _, tpl = params(**LANE)
    return spawn_ranks(ranks.sequence, 4, "gloo",
                       _call(ranks.fly_cycles, tm16, tp, F64, "cpu", 3),
                       _call(ranks.fly_cycles, tlanes, tpl, F64, "cpu", 3,
                             halo_shards=1, sort_key="axis:1"),
                       _call(ranks.run_mission, tlanes, tpl, F64, "cpu",
                             300, halo_shards=1, sort_key="axis:1"),
                       _call(ranks.dryrun_d, "cpu"))


@pytest.fixture(scope="module")
def world6():
    """6 ranks as 3 hosts x 2 chips, 12 agents: all_gather, host halo 1."""
    _, tm = missions("make_circle_mission", 12, radius=4.0)
    _, tp = params(**EXACT)
    return spawn_ranks(ranks.sequence, 6, "gloo",
                       _call(ranks.fly_cycles, tm, tp, F64, "cpu", 3,
                             mesh_shape=(3, 2)),
                       _call(ranks.fly_cycles, tm, tp, F64, "cpu", 3,
                             mesh_shape=(3, 2), halo_shards=1))


@pytest.fixture(scope="module")
def world2():
    """2 ranks: the 8-agent circle through run(cycle_fn=...), dry-run part
    (e) in f64, profile_sharded of both exchanges."""
    _, tm8 = missions("make_circle_mission", 8, radius=3.0,
                      world=(-5, -5, 0, 5, 5, 2.5))
    _, tm16 = missions("make_circle_mission", 16, radius=4.0)
    _, tp = params(**EXACT)
    return spawn_ranks(ranks.sequence, 2, "gloo",
                       _call(ranks.run_mission, tm8, tp, F64, "cpu", 300),
                       _call(ranks.dryrun_e, "cpu", F64),
                       _call(ranks.profile, tm16, tp, F64, "cpu",
                             n_cycles=2))


# ------------------------------------------------------------ all_gather
def test_all_gather_cycles_match_jax(world4):
    """16 agents on 4 ranks, 3 cycles, against JAX's make_sharded_cycle on
    make_mesh(4) and against the port's own single-process cycle."""
    jm, tm = missions("make_circle_mission", 16, radius=4.0)
    jp, tp = params(**EXACT)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    jtrajs, jstate = _jax_cycles(jsim, jshard.make_mesh(4), 3)
    got = [r[0] for r in world4]
    _same_on_every_rank([g["traj"] for g in got], 3)
    for c in range(1, 4):
        assert np.abs(got[0]["traj"][c] - jtrajs[c - 1]).max() <= 1e-8
    assert abs(got[0]["safety_agent_min"] -
               float(jstate.safety_agent_min)) <= 1e-8
    assert abs(got[0]["distance"] - float(jstate.distance)) <= 1e-7
    tsim = TSim(tm, tp, device="cpu", dtype=F64)
    state = tsim.initial_state()
    for c in range(1, 4):
        state, _ = tsim.cycle(state)
        assert np.abs(got[0]["traj"][c] - state.traj.numpy()).max() <= 1e-8


def test_sorted_lane_halo_cycles_match_jax(world4):
    """lanes16 on 4 ranks with H = 1 and an axis:1 sort before every
    cycle: the first 3 cycles against JAX's on make_mesh(4)."""
    jm, _ = missions("make_lane_mission", 16, lane_gap=2.0, length=6.0)
    jp, _ = params(**LANE)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    jtrajs, _ = _jax_cycles(jsim, jshard.make_mesh(4), 3, halo=1,
                            sort=_lane_sort(jsim))
    got = [r[1] for r in world4]
    for c in range(1, 4):
        for g in got:
            assert np.abs(g["traj"][c] - jtrajs[c - 1]).max() <= 1e-8


def test_sorted_lane_halo_run_finishes(world4):
    """The same lanes through run(cycle_fn=...): finished under the cap,
    collision-free (tests/test_shard.py's requirement of JAX), with the
    same summary on every rank."""
    summaries = [r[2] for r in world4]
    s = summaries[0]
    assert s["iterations"] < 300
    assert not s["is_collided"]
    assert s["safety_ratio_agent"] >= 1.0
    assert s["qp_failures"] == 0
    for other in summaries[1:]:
        for k in ("iterations", "total_flight_distance",
                  "safety_ratio_agent", "qp_failures", "is_collided"):
            assert other[k] == s[k]


# ------------------------------------------------------------ ring halo
def test_full_window_halo_matches_jax():
    """3 ranks, H = 1, 6 agents: the window is the whole swarm; against
    JAX's halo cycle on make_mesh(3)."""
    jm, tm = missions("make_circle_mission", 6, radius=4.0)
    jp, tp = params(**EXACT)
    got = spawn_ranks(ranks.fly_cycles, 3, "gloo", tm, tp, F64, "cpu", 3,
                      1)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    jtrajs, jstate = _jax_cycles(jsim, jshard.make_mesh(3), 3, halo=1)
    for g in got:
        for c in range(1, 4):
            assert np.abs(g["traj"][c] - jtrajs[c - 1]).max() <= 1e-7
        assert abs(g["safety_agent_min"] -
                   float(jstate.safety_agent_min)) <= 1e-8


# ------------------------------------------------------------ 2-axis layout
@pytest.mark.parametrize("case,halo,tol", [(0, None, 1e-8), (1, 1, 1e-7)])
def test_mesh2d_matches_jax(world6, case, halo, tol):
    """(3 hosts x 2 chips), 12 agents, 3 cycles: the all_gather exchange
    within 1e-8 m, the host halo (H = 1, a full window) within 1e-7 m of
    JAX's make_mesh_2d(3, 2)."""
    jm, _ = missions("make_circle_mission", 12, radius=4.0)
    jp, _ = params(**EXACT)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    jtrajs, jstate = _jax_cycles(jsim, jshard.make_mesh_2d(3, 2), 3,
                                 halo=halo)
    for r in world6:
        g = r[case]
        for c in range(1, 4):
            assert np.abs(g["traj"][c] - jtrajs[c - 1]).max() <= tol
        assert abs(g["distance"] - float(jstate.distance)) <= 1e-7


# ------------------------------------------------------------ run(cycle_fn)
def test_run_with_sharded_cycle_fn_matches_jax(world2):
    """8 agents on 2 ranks through run(cycle_fn=...): JAX's iterations and
    safety, and the same summary on every rank."""
    jm, _ = missions("make_circle_mission", 8, radius=3.0,
                     world=(-5, -5, 0, 5, 5, 2.5))
    jp, _ = params(**EXACT)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    cyc = jshard.make_sharded_cycle(jsim, jshard.make_mesh(2))
    want = jsim.run(max_iterations=300, cycle_fn=cyc)
    got = [r[0] for r in world2]
    for g in got:
        assert g["iterations"] == want["iterations"] < 300
        assert abs(g["safety_ratio_agent"] -
                   want["safety_ratio_agent"]) <= 1e-8
        assert g["is_collided"] == want["is_collided"] is False
        assert g["qp_failures"] == want["qp_failures"] == 0
    # every rank's final state is the whole swarm's
    assert got[0]["final_state"]["traj"].shape[0] == 8
    np.testing.assert_array_equal(got[0]["final_state"]["traj"],
                                  got[1]["final_state"]["traj"])


def test_dryrun_part_e_matches_jax(world2):
    """Dry-run part (e) in f64 on 2 ranks against the same three cases
    through JAX's sharded cycle on make_mesh(2): the QPFAILED fallback's
    trajectories, the patrol swap, a cycle with a spin obstacle."""
    import dataclasses
    from lsc_planner_tpu import config as jcfg
    from lsc_planner_tpu import missions as jmis
    mesh = jshard.make_mesh(2)
    got = [r[1] for r in world2]
    _same_on_every_rank(got, "failed_traj")

    def jsim_of(mission=None, **kw):
        kw.setdefault("goal_mode", jcfg.GoalMode.PRIOR_BASED)
        mission = mission or jmis.make_circle_mission(
            4, radius=4.0, world=(-6, -6, 0, 6, 6, 2.5))
        return JSim(mission, jcfg.Param(**kw), dtype=jnp.float64)

    sim_f = jsim_of(qp_iterations=4, max_neighbors=-1,
                    qp_failure_threshold=-1.0)
    st_f1, info_f = jshard.make_sharded_cycle(sim_f, mesh)(
        jshard.shard_state(sim_f.initial_state(), mesh))
    assert np.asarray(info_f.qp_failed).all() and got[0]["failed"].all()
    assert np.abs(got[0]["failed_traj"] -
                  np.asarray(st_f1.traj)).max() <= 1e-10
    assert got[0]["fallback_err"] <= 1e-10

    m_p = jmis.make_circle_mission(4, radius=4.0,
                                   world=(-6, -6, 0, 6, 6, 2.5))
    sim_p = jsim_of(m_p, goal_mode=jcfg.GoalMode.STATIC, qp_iterations=4,
                    max_neighbors=-1, multisim_patrol=True)
    st_p = jshard.shard_state(sim_p.initial_state(), mesh)
    st_p = st_p._replace(pos=st_p.desired_goal, traj=jnp.broadcast_to(
        st_p.desired_goal[:, None, None, :], st_p.traj.shape))
    st_p1, _ = jshard.make_sharded_cycle(sim_p, mesh)(st_p)
    np.testing.assert_array_equal(got[0]["patrol_goal"],
                                  np.asarray(st_p1.desired_goal))

    m_d = dataclasses.replace(m_p, obstacles=[jmis.ObstacleSpec(
        kind="spin", size=0.3, max_acc=1.0,
        axis_position=np.array([0.0, 0.0, 1.0]),
        axis_ori=np.array([0.0, 0.0, 1.0]),
        start=np.array([1.5, 0.0, 1.0]), speed=0.5)])
    sim_d = jsim_of(m_d, qp_iterations=4, max_neighbors=-1)
    dp, dv = sim_d.obstacle_generator.update(0.0)
    st_d1, _ = jshard.make_sharded_cycle(sim_d, mesh)(
        jshard.shard_state(sim_d.initial_state(), mesh),
        jnp.asarray(dp), jnp.asarray(dv))
    assert np.abs(got[0]["dyn_traj"] -
                  np.asarray(st_d1.traj)).max() <= 1e-8
    assert abs(got[0]["dyn_safety_obs"] -
               float(st_d1.safety_obs_min)) <= 1e-10


def test_profile_sharded_keys(world2):
    """profile_sharded returns the JAX package's keys, the same (slowest
    rank's) numbers on every rank."""
    got = [r[2] for r in world2]
    want_keys = {"exchange", "cycle_total", "local_compute_est",
                 "n_devices", "halo_shards"}
    for g in got:
        assert set(g) == want_keys
        assert g["cycle_total"] > 0 and g["exchange"] > 0
        assert g["local_compute_est"] >= 0
        assert g["n_devices"] == 2 and g["halo_shards"] is None
    assert got[0] == got[1]


# ------------------------------------------------------------ the dry run
def test_dryrun_multichip_on_four_ranks():
    """dryrun_multichip(4, "gloo", "cpu"): parts (a), (b), (c) and (e) pass
    on every rank (JAX's conditions on the device count); (b) runs on the
    3-rank sub-mesh, which the fourth rank only joins as a group."""
    out = shard.dryrun_multichip(4, "gloo", "cpu")
    assert len(out) == 4
    for parts in out:
        assert set(parts) == {"a", "b", "c", "e"}
        assert parts["a"]["safety"] >= 1.0 and parts["c"]["safety"] >= 1.0
    assert all(p["b"]["max_diff"] <= 1e-7 for p in out[:3])
    assert out[3]["b"]["max_diff"] is None


def test_dryrun_part_d_on_four_hosts(world4):
    """Dry-run part (d), which dryrun_multichip runs from 8 ranks on, on
    a (4 hosts x 1 chip) mesh: a cycle of the all_gather exchange with
    K-NN pruning and one of the host halo, the same on every rank."""
    got = [r[3] for r in world4]
    assert set(got[0]) == {"all_gather", "host_halo"}
    assert all(g == got[0] for g in got)
    assert got[0]["all_gather"] > 0 and got[0]["host_halo"] > 0


# ------------------------------------------------------------ sorting
def test_morton_codes_equal_jax(rng):
    pos = rng.uniform(-10, 10, size=(256, 3))
    wmin, wmax = np.array([-10.0, -9.0, -8.0]), np.array([10.0, 9.5, 8.0])
    want = np.asarray(jshard.morton_codes(jnp.asarray(pos), wmin, wmax))
    got = shard.morton_codes(torch.as_tensor(pos), wmin, wmax).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # the codes are 30 bits
    assert got.max() < 2 ** 30


@pytest.mark.parametrize("key", ["morton", "axis:0", "axis:1"])
def test_spatial_sort_permutation_equals_jax(rng, key):
    """spatial_sort_state of the whole swarm (no mesh) moves every
    per-agent field as JAX's does; positions with ties (quantised) check
    the sort's stability."""
    jm, tm = missions("make_circle_mission", 16, radius=4.0)
    jp, tp = params(**EXACT)
    jsim = JSim(jm, jp, dtype=jnp.float64)
    js = jsim.initial_state()
    pos = np.round(rng.uniform(-4, 4, size=(16, 3)), 0)
    js = js._replace(pos=jnp.asarray(pos), vel=jnp.asarray(
        rng.normal(size=(16, 3))))
    wmin, wmax = jm.world_min, jm.world_max
    want = jshard.spatial_sort_state(js, wmin, wmax, key=key)
    got = shard.spatial_sort_state(port_state(js), wmin, wmax, key=key)
    for name, w in want._asdict().items():
        g = getattr(got, name)
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ in-process
@pytest.fixture
def group_of_one():
    """A gloo process group of one rank in this process."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_world_of_one_equals_single_cycle_bits(group_of_one):
    """A mesh of one rank: the sharded cycle's trajectories equal the
    single cycle's bit for bit (the same batch through plan_block), also
    with K-NN pruning, and the stats equal run()'s own read."""
    _, tm = missions("make_circle_mission", 12, radius=4.0)
    for kw in (dict(EXACT), dict(EXACT, max_neighbors=5)):
        _, tp = params(**kw)
        sim = TSim(tm, tp, device="cpu", dtype=F64)
        cycle = shard.make_sharded_cycle(sim, shard.make_mesh(device="cpu"))
        a = b = sim.initial_state()
        for _ in range(3):
            a, ia = cycle(a)
            b, ib = sim.cycle(b)
            for name in ("traj", "pos", "current_goal", "stall_count"):
                assert torch.equal(getattr(a, name), getattr(b, name))
            assert torch.equal(ia.safety_step_min, ib.safety_step_min)
        got = cycle.stats(a, ia).tolist()
        assert got[0] == float(ib.safety_step_min) and got[1] == 0.0


def test_sharded_cycle_refusals(group_of_one):
    """The argument checks of the JAX package: a halo window past the
    ring, a halo on an inhomogeneous swarm, an agent count the mesh does
    not divide, per-agent obstacle predictions, a simulator on another
    device; run() refuses cycle_fn with several cycles a dispatch."""
    _, tm = missions("make_circle_mission", 6, radius=4.0)
    _, tp = params(**EXACT)
    sim = TSim(tm, tp, device="cpu", dtype=F64)
    mesh = shard.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="halo window"):
        shard.make_sharded_cycle(sim, mesh, halo_shards=1)
    cycle = shard.make_sharded_cycle(sim, mesh, halo_shards=0)
    with pytest.raises(ValueError, match="predictions"):
        cycle(cycle.shard(sim.initial_state()), None, None,
              torch.zeros(1))
    tm.agents[0].radius = 0.3
    odd = TSim(tm, tp, device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="homogeneous"):
        shard.make_sharded_cycle(odd, mesh, halo_shards=0)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        sim.run(max_iterations=2, cycle_fn=cycle, steps_per_dispatch=2)


def test_spawn_refusals_and_rank_failure():
    """nccl with more ranks than cards raises before anything starts; an
    unknown backend raises; a rank that raises fails the call (3 agents
    do not divide over 2 ranks)."""
    _, tm = missions("make_circle_mission", 3, radius=2.0)
    _, tp = params(**EXACT)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="one card a rank"):
        spawn_ranks(ranks.fly_cycles, n + 1, "nccl", tm, tp)
    with pytest.raises(ValueError, match="backend"):
        spawn_ranks(ranks.fly_cycles, 1, "mpi", tm, tp)
    with pytest.raises(Exception, match="divisible"):
        spawn_ranks(ranks.fly_cycles, 2, "gloo", tm, tp, F64, "cpu", 1)


def test_shard_and_gather_states(group_of_one):
    """shard_state of a mesh of one keeps every field; state_specs marks
    the per-agent fields and leaves the scalars whole."""
    _, tm = missions("make_circle_mission", 4, radius=2.0)
    _, tp = params(**EXACT)
    sim = TSim(tm, tp, device="cpu", dtype=F64)
    mesh = shard.make_mesh(device="cpu")
    whole = sim.initial_state()
    back = shard.gather_state(shard.shard_state(whole, mesh), mesh)
    for name, a in state_to_numpy(whole).items():
        np.testing.assert_array_equal(state_to_numpy(back)[name], a)
    specs = shard.state_specs()
    assert {n for n, s in specs._asdict().items() if s is None} == {
        "seq", "safety_agent_min", "distance", "safety_obs_min"}
    assert mesh.index == 0 and mesh.size == 1 and mesh.group is None
