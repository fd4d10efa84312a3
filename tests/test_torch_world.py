"""Port parity: the static world (ESDF, occupancy SAT, SFC corridors, SFC
planes, the static-box audit) against the JAX package.

The same numpy inputs go through the JAX function (CPU, float64 under
conftest) and its PyTorch counterpart.  Stated tolerances: ESDF.from_boxes
and at_points exact; from_occupancy within 1e-6 m (scipy's EDT on both
sides, or the JAX package's native EDT); box checks, corridor boxes and
their flags exact; SFC planes and the static-box audit exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu.planner import constraints as jcons
from lsc_planner_tpu.sim import audit as jaudit
from lsc_planner_tpu.world import corridor as jcor
from lsc_planner_tpu.world.esdf import ESDF as JESDF
from lsc_planner_tpu.world.esdf import OccupancySAT as JSAT
from lsc_planner_tpu_torch import missions as tmis
from lsc_planner_tpu_torch.convert import esdf_from_numpy, esdf_to_numpy
from lsc_planner_tpu_torch.planner import constraints as tcons
from lsc_planner_tpu_torch.sim import audit as taudit
from lsc_planner_tpu_torch.world import corridor as tcor
from lsc_planner_tpu_torch.world.esdf import ESDF as TESDF
from lsc_planner_tpu_torch.world.esdf import OccupancySAT as TSAT
from test_torch_cuda import forest_mission
from torch_parity import torch_one_thread  # noqa: F401

WORLD = (-3.0, -3.0, 0.0, 3.0, 3.0, 2.5)


def _t(a):
    return torch.as_tensor(np.array(a))


def _boxes(m):
    return np.stack([np.concatenate([o.pose - o.dimensions,
                                     o.pose + o.dimensions])
                     for o in m.obstacles])


def _forest(seed=3, qn=4, n_trees=12):
    return (forest_mission(jmis, seed, qn, n_trees, WORLD),
            forest_mission(tmis, seed, qn, n_trees, WORLD))


def _esdfs(dtype=jnp.float64):
    jm, _ = _forest()
    j = JESDF.from_boxes(_boxes(jm), WORLD[:3], WORLD[3:], resolution=0.1,
                         dtype=dtype)
    t = TESDF.from_boxes(_boxes(jm), WORLD[:3], WORLD[3:], resolution=0.1,
                         dtype=torch.float64 if dtype == jnp.float64
                         else torch.float32, device="cpu")
    return j, t


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_esdf_from_boxes_and_at_points_exact(rng, dtype):
    j, t = _esdfs(dtype)
    jd, td = esdf_to_numpy(j), esdf_to_numpy(t)
    assert td["dist"].dtype == jd["dist"].dtype
    np.testing.assert_array_equal(td["dist"], jd["dist"])
    np.testing.assert_array_equal(td["occ"], jd["occ"])
    np.testing.assert_array_equal(td["origin_key"], jd["origin_key"])
    assert (td["resolution"], td["max_dist"]) == (jd["resolution"],
                                                   jd["max_dist"])
    # points in and beyond the grid (clamped to the border cells)
    pts = rng.uniform(-3.5, 3.5, size=(7, 50, 3))
    pts[..., 2] = rng.uniform(-0.3, 2.8, size=(7, 50))
    pts = pts.astype(np.float64 if dtype == jnp.float64 else np.float32)
    np.testing.assert_array_equal(t.at_points(_t(pts)).numpy(),
                                  np.asarray(j.at_points(jnp.asarray(pts))))
    # the converter carries a JAX ESDF over unchanged
    back = esdf_to_numpy(esdf_from_numpy(jd, device="cpu",
                                         dtype=t.dist.dtype))
    np.testing.assert_array_equal(back["dist"], jd["dist"])


def test_esdf_from_occupancy_within_1e6(rng):
    occ = rng.uniform(size=(30, 24, 12)) < 0.04
    j = JESDF.from_occupancy(occ, (-15, -12, 0), 0.1, dtype=jnp.float64)
    t = TESDF.from_occupancy(occ, (-15, -12, 0), 0.1, dtype=torch.float64,
                             device="cpu")
    assert np.abs(t.dist.numpy() - np.asarray(j.dist)).max() <= 1e-6
    empty = TESDF.from_occupancy(np.zeros((4, 4, 4), bool), (0, 0, 0), 0.1,
                                 device="cpu")
    assert bool((empty.dist == 1.0).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TESDF.from_bt("world.bt", WORLD[:3], WORLD[3:])


@pytest.mark.parametrize("margin", [0.0, 0.15])
def test_box_obstructed_exact(rng, margin):
    j, t = _esdfs()
    jsat, tsat = JSAT.build(j, margin), TSAT.build(t, margin)
    np.testing.assert_array_equal(tsat.sat.numpy(), np.asarray(jsat.sat))
    k0 = np.asarray(j.origin_key)
    dims = np.asarray(j.dist.shape)
    lo = k0 + rng.integers(-2, dims - 4, size=(40, 3))
    hi = lo + rng.integers(0, 12, size=(40, 3))
    at_min = rng.uniform(size=(40, 3)) < 0.3
    args = (lo.astype(np.int32), hi.astype(np.int32), at_min)
    got = tsat.box_obstructed(*map(_t, args)).numpy()
    want = np.asarray(jsat.box_obstructed(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 40              # both outcomes are exercised
    np.testing.assert_array_equal(
        tsat._box_count(_t(lo - k0), _t(hi - k0)).numpy(),
        np.asarray(jsat._box_count(jnp.asarray(lo - k0),
                                   jnp.asarray(hi - k0))))


def _builders(dtype=jnp.float64):
    j, t = _esdfs(dtype)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    return (jcor.CorridorBuilder(j, np.asarray(WORLD[:3]),
                                 np.asarray(WORLD[3:]), 0.15, dtype=dtype),
            tcor.CorridorBuilder(t, np.asarray(WORLD[:3]),
                                 np.asarray(WORLD[3:]), 0.15, dtype=tdt))


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_expand_boxes_exact(dtype):
    """The 4-agent forest's starts (toward their goals) and its goals
    (toward the starts), a seed at the world's low corner and one inside a
    tree (seed_ok False): equal boxes and flags."""
    jb, tb = _builders(dtype)
    jm, _ = _forest()
    starts = np.stack([a.start for a in jm.agents])
    goals = np.stack([a.goal for a in jm.agents])
    tree = jm.obstacles[0].pose
    pts = np.concatenate([starts, goals, [[-3.0, -3.0, 0.0], tree]])
    tgt = np.concatenate([goals, starts, [[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]])
    np_dt = np.float64 if dtype == jnp.float64 else np.float32
    pts, tgt = pts.astype(np_dt), tgt.astype(np_dt)
    jres = jb.expand_boxes(jnp.asarray(pts), jnp.asarray(tgt))
    tres = tb.expand_boxes(_t(pts), _t(tgt))
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not bool(tres[2][-1]) and bool(tres[2][:-1].all())
    # boxes grew beyond their seeds
    assert bool(((tres[1] - tres[0])[:-2] > 0.5).all())


@pytest.mark.parametrize("init", [True, False])
def test_update_sfc_exact(rng, init):
    """update_sfc on the 4-agent forest, including a seed trapped inside
    a tree's margin (escape + extension) and one inside a tree (kept
    window)."""
    jb, tb = _builders()
    jm, _ = _forest()
    N, M = 6, 5
    starts = np.stack([a.start for a in jm.agents])
    goals = np.stack([a.goal for a in jm.agents])
    tree = jm.obstacles[0].pose
    seeds = np.concatenate([starts, [tree + np.array([0.2, 0.0, 0.0]),
                                     tree]])
    tgt = np.concatenate([goals, goals[:2]])
    prev = np.concatenate([seeds - 0.3, seeds + 0.3], axis=-1)
    prev = np.broadcast_to(prev[:, None], (N, M, 6)) + \
        rng.normal(size=(N, M, 6)) * 0.01
    initialize = np.full(N, init)
    args = (prev, seeds, tgt)
    jout = jcor.update_sfc(*map(jnp.asarray, args), jb,
                           jnp.asarray(initialize))
    tout = tcor.update_sfc(*map(_t, args), tb, _t(initialize))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j_esc = jcor.escape_seeds(jb, jnp.asarray(seeds))
    t_esc = tcor.escape_seeds(tb, _t(seeds))
    for a, b in zip(t_esc, j_esc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(t_esc[1][-2]) and not bool(tout[1][-1])


@pytest.mark.parametrize("guard", [0.0, 0.004])
def test_sfc_planes_match(rng, guard):
    N, M, n1 = 4, 5, 6
    lo = rng.uniform(-2, 0, size=(N, M, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.2, 2, size=(N, M, 3))],
                           axis=-1)
    init = lo[:, :, None] + rng.uniform(0, 0.3, size=(N, M, n1, 3))
    kw = dict(guard_margin=guard)
    j = jcons.sfc_planes(jnp.asarray(boxes), True,
                         init_traj=jnp.asarray(init), **kw)
    t = tcons.sfc_planes(_t(boxes), True, init_traj=_t(init), **kw)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jc = jcons.concat_planes(j, j, n_ctrl=n1)
    tc = tcons.concat_planes(t, t, n_ctrl=n1)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_static_box_audit_matches(rng):
    jm, _ = _forest()
    boxes = _boxes(jm)
    pos = rng.uniform(-3, 3, size=(9, 3))
    radius = rng.uniform(0.1, 0.2, size=9)
    got = taudit.static_box_safety_ratio(_t(pos), _t(boxes), _t(radius))
    want = jaudit.static_box_safety_ratio(jnp.asarray(pos),
                                          jnp.asarray(boxes),
                                          jnp.asarray(radius))
    assert abs(float(got) - float(want)) <= 1e-12
