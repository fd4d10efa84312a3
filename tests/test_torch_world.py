"""Port parity: the static world (ESDF, occupancy SAT, SFC corridors, SFC
planes, the static-box audit) against the JAX package.

The same numpy inputs go through the JAX function (CPU, float64 under
conftest) and its PyTorch counterpart.  Stated tolerances: ESDF.from_boxes
and at_points exact; from_occupancy within 1e-6 m (scipy's EDT on both
sides, or the JAX package's native EDT); box checks, corridor boxes and
their flags exact; SFC planes and the static-box audit exact.  .bt worlds:
each package's save_bt writes the same bytes and reads the other's trees
to the last key; ESDF.from_bt equals the JAX package's from_bt on its
Python path bit for bit (its native path's EDT within 1e-6 m), and its own
from_occupancy of the occupancy the file was written from bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu.planner import constraints as jcons
from lsc_planner_tpu.sim import audit as jaudit
from lsc_planner_tpu.world import corridor as jcor
from lsc_planner_tpu.world import mapping as jmap
from lsc_planner_tpu.world import octomap_io as jio
from lsc_planner_tpu.world.esdf import ESDF as JESDF
from lsc_planner_tpu.world.esdf import OccupancySAT as JSAT
from lsc_planner_tpu_torch import missions as tmis
from lsc_planner_tpu_torch.convert import esdf_from_numpy, esdf_to_numpy
from lsc_planner_tpu_torch.planner import constraints as tcons
from lsc_planner_tpu_torch.sim import audit as taudit
from lsc_planner_tpu_torch.world import corridor as tcor
from lsc_planner_tpu_torch.world import mapping as tmap
from lsc_planner_tpu_torch.world import octomap_io as tio
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


def test_esdf_from_occupancy_within_1e6(rng, tmp_path):
    occ = rng.uniform(size=(30, 24, 12)) < 0.04
    j = JESDF.from_occupancy(occ, (-15, -12, 0), 0.1, dtype=jnp.float64)
    t = TESDF.from_occupancy(occ, (-15, -12, 0), 0.1, dtype=torch.float64,
                             device="cpu")
    assert np.abs(t.dist.numpy() - np.asarray(j.dist)).max() <= 1e-6
    empty = TESDF.from_occupancy(np.zeros((4, 4, 4), bool), (0, 0, 0), 0.1,
                                 device="cpu")
    assert bool((empty.dist == 1.0).all())
    # the same occupancy through a .bt file: its own from_occupancy's bits
    bt, lo, hi = _write_bt(tmp_path, occ, (-15, -12, 0), 0.1)
    back = TESDF.from_bt(bt, lo, hi, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(back.occ, occ)
    np.testing.assert_array_equal(back.origin_key, (-15, -12, 0))
    assert torch.equal(back.dist, t.dist)


def _write_bt(tmp_path, occ, origin_key, res, name="world.bt", free=None):
    """occ (X, Y, Z) written as a .bt with the port's save_bt (free: the
    keys written as free leaves); returns (path, world_min, world_max) of
    the box whose cell centres are occ's cells."""
    keys = tmap.occupancy_to_keys(occ, origin_key)
    path = str(tmp_path / name)
    tmap.save_bt(path, keys, res, free_keys=free)
    k0 = np.asarray(origin_key, np.float64)
    return (path, (k0 + 0.5) * res,
            (k0 + np.asarray(occ.shape) - 0.5) * res)


def _voxels(tree):
    """The occupied voxel keys of a tree, sorted."""
    out = [low + np.array([dx, dy, dz])
           for low, size in zip(tree.occupied_low, tree.occupied_size)
           for dx in range(size) for dy in range(size) for dz in range(size)]
    return np.unique(np.asarray(out), axis=0)


@pytest.mark.parametrize("res", [0.1, 0.25])
def test_bt_round_trips_across_packages(rng, tmp_path, res):
    """A cloud voxelized and written by each package: the same bytes, and
    each package's reader gives the other's trees and rasters."""
    pts = rng.uniform(-3, 3, size=(1500, 3))
    keys = tmap.voxelize(pts, res)
    np.testing.assert_array_equal(keys, jmap.voxelize(pts, res))
    free = tmap.voxelize(rng.uniform(3.2, 4, size=(200, 3)), res)
    tp, jp = str(tmp_path / "t.bt"), str(tmp_path / "j.bt")
    assert tmap.save_bt(tp, keys, res, free_keys=free) == \
        jmap.save_bt(jp, keys, res, free_keys=free)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    for bit in ("first", "second"):
        t, j = tio.load_bt(jp, bit), jio.load_bt(tp, bit)
        assert t.resolution == j.resolution == res
        for f in ("occupied_low", "occupied_size", "free_low", "free_size"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        for got, want in zip(tio.rasterize(t, (-3, -3, -3), (3, 3, 3)),
                             jio.rasterize(j, (-3, -3, -3), (3, 3, 3))):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_voxels(tio.load_bt(tp)), keys)


def test_from_bt_matches_jax_on_a_written_cloud(rng, tmp_path,
                                                monkeypatch):
    """pointcloud_to_bt of a cloud of pillars, loaded by both packages'
    ESDF.from_bt: bit for bit with the JAX package's Python path (the one
    the port follows), within 1e-6 m of its native EDT."""
    from lsc_planner_tpu import native

    cols = rng.uniform(-2.5, 2.5, size=(6, 2))
    z = rng.uniform(0.0, 2.4, size=(6, 300))
    pts = np.concatenate([np.stack([np.broadcast_to(c[0], zz.shape) +
                                    rng.uniform(-0.1, 0.1, zz.shape),
                                    np.broadcast_to(c[1], zz.shape) +
                                    rng.uniform(-0.1, 0.1, zz.shape), zz],
                                   -1) for c, zz in zip(cols, z)])
    path = str(tmp_path / "pillars.bt")
    tmap.pointcloud_to_bt(pts, 0.1, path)
    t = TESDF.from_bt(path, WORLD[:3], WORLD[3:], dtype=torch.float64,
                      device="cpu")
    j_native = JESDF.from_bt(path, WORLD[:3], WORLD[3:], dtype=jnp.float64)
    monkeypatch.setattr(native, "load", lambda: None)
    j = JESDF.from_bt(path, WORLD[:3], WORLD[3:], dtype=jnp.float64)
    td, jd = esdf_to_numpy(t), esdf_to_numpy(j)
    for k in ("dist", "occ", "origin_key"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    assert td["resolution"] == jd["resolution"] == 0.1
    np.testing.assert_array_equal(td["occ"], np.asarray(j_native.occ))
    assert np.abs(td["dist"] - np.asarray(j_native.dist)).max() <= 1e-6
    assert 0.001 < td["occ"].mean() < 0.5


def test_from_bt_swaps_the_occupied_bit_of_a_solid_world(tmp_path,
                                                         monkeypatch):
    """A world written mostly solid (occupied leaves) around a few free
    voxels reads as more than half occupied with the first bit, so both
    packages read it again with the second: the free voxels become the
    occupancy.  A world written the usual way keeps the first bit."""
    from lsc_planner_tpu import native

    monkeypatch.setattr(native, "load", lambda: None)
    dims = (24, 20, 10)
    occ = np.zeros(dims, bool)
    occ[5:9, 4:7, :] = True
    occ[15:18, 12:16, 2:8] = True
    solid = tmap.occupancy_to_keys(~occ, (-12, -10, 0))
    free = tmap.occupancy_to_keys(occ, (-12, -10, 0))
    for name, written, want in (("usual", occ, occ), ("solid", ~occ, occ)):
        path, lo, hi = _write_bt(
            tmp_path, written, (-12, -10, 0), 0.1, name=name + ".bt",
            free=free if name == "solid" else None)
        first, _ = tio.rasterize(tio.load_bt(path), lo, hi)
        assert (first.mean() > 0.5) == (name == "solid")
        t = TESDF.from_bt(path, lo, hi, dtype=torch.float64, device="cpu")
        j = JESDF.from_bt(path, lo, hi, dtype=jnp.float64)
        np.testing.assert_array_equal(t.occ, want)
        np.testing.assert_array_equal(t.occ, np.asarray(j.occ))
        np.testing.assert_array_equal(t.dist.numpy(), np.asarray(j.dist))
    assert len(solid) > len(free)


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
