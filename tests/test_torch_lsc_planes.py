"""The LSC planes' wrapper and plain version (ops/lsc_planes.py) on the CPU.

The kernel (csrc/planes.cu) copies the plain version's function bit for
bit on the card (tests/test_torch_cuda.py holds it there); these tests pin
the semantics it copies: the plain version is the body of
constraints.lsc_planes before the kernel, the enumeration's first-minimum
pick, the interior test's +x fallback, the zero signs of the outputs, the
routing of large hulls to FISTA, and the wrapper's bookkeeping.
"""
import pytest
import torch

from lsc_planner_tpu_torch import trace
from lsc_planner_tpu_torch.ops import _build, hull
from lsc_planner_tpu_torch.ops import lsc_planes as lsc_ops
from lsc_planner_tpu_torch.planner import constraints as cons
from lsc_planner_tpu_torch.planner.optimizer import PlaneConstraints
from test_torch_cuda import lsc_planes_case, same_bits

CASES = [("random", (6, 5, 3, 6)), ("guard", (6, 5, 3, 6)),
         ("slack", (6, 5, 3, 6)), ("degenerate", (4, 6, 5, 6)),
         ("random", (5, 4, 2, 3)), ("degenerate", (3, 6, 4, 8))]
DTYPES = [torch.float32, torch.float64]


def pre_move_lsc_planes(init_traj, obs_pred, agent_radius, agent_downwash,
                        obs_radius, obs_downwash, obs_is_agent, obs_mask,
                        slack_flags=None, obs_pred_sizes=None,
                        guard_margin: float = 0.0) -> PlaneConstraints:
    """planner/constraints.py::lsc_planes as it was before the kernel,
    kept here as the plain version's yardstick."""
    N, O, M = obs_pred.shape[:3]

    dw_agent = ((agent_downwash[:, None] * agent_radius[:, None] +
                 obs_downwash * obs_radius) /
                (agent_radius[:, None] + obs_radius))
    dw_other = ((agent_radius[:, None] + obs_downwash * obs_radius) /
                (agent_radius[:, None] + obs_radius))
    dw = torch.where(obs_is_agent, dw_agent, dw_other)
    scale = torch.stack([torch.ones_like(dw), torch.ones_like(dw),
                         1.0 / dw], dim=-1)
    init_t = init_traj[:, None] * scale[:, :, None, None, :]
    obs_t = obs_pred * scale[:, :, None, None, :]

    rel = init_t - obs_t
    normal_t, _ = hull.hull_normal(rel)

    collision_dist = agent_radius[:, None] + obs_radius
    e = (rel * normal_t[..., None, :]).sum(-1)
    d = 0.5 * (collision_dist[..., None, None] + e)
    if guard_margin > 0.0:
        s0 = 0.5 * (e - collision_dist[..., None, None])
        d = d + torch.clamp(0.5 * s0, 0.0, guard_margin)
    if slack_flags is not None and obs_pred_sizes is not None:
        use_rsfc = slack_flags & ~obs_is_agent
        d_rsfc = obs_pred_sizes + agent_radius[:, None, None, None]
        d = torch.where(use_rsfc[..., None, None], d_rsfc, d)

    normal = torch.cat([normal_t[..., :2],
                        normal_t[..., 2:3] / dw[..., None, None]], dim=-1)
    rhs = d + (obs_pred * normal[..., None, :]).sum(-1)
    mask = obs_mask[..., None].expand(N, O, M)
    return PlaneConstraints(normal=normal, rhs=rhs, mask=mask)


def same_planes(a, b):
    return (same_bits(a.normal, b.normal) and same_bits(a.rhs, b.rhs)
            and torch.equal(a.mask, b.mask))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,shape", CASES)
def test_the_wrapper_runs_the_plain_version_on_the_cpu(case, shape, dtype,
                                                       monkeypatch):
    """constraints.lsc_planes on CPU tensors is lsc_planes_plain, bit for
    bit, and launches nothing."""
    def no_kernel(*args):
        raise AssertionError("the kernel path ran for a CPU tensor")
    monkeypatch.setattr(lsc_ops, "_lsc_planes_cuda", no_kernel)
    args, kw = lsc_planes_case(case, shape, dtype, "cpu", seed=7)
    lsc_ops.reset_counts()
    got = cons.lsc_planes(*args, **kw)
    assert same_planes(got, lsc_ops.lsc_planes_plain(*args, **kw))
    assert lsc_ops.lsc_planes_launches == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,shape", CASES)
def test_the_plain_version_is_the_pre_move_function(case, shape, dtype):
    """lsc_planes_plain equals constraints.lsc_planes as it was before the
    kernel, bit for bit: the guard band, the slack branch, degenerate
    hulls, and slack flags without sizes (ignored)."""
    args, kw = lsc_planes_case(case, shape, dtype, "cpu", seed=11)
    assert same_planes(lsc_ops.lsc_planes_plain(*args, **kw),
                       pre_move_lsc_planes(*args, **kw))
    if case == "slack":
        kw.pop("obs_pred_sizes")
        assert same_planes(lsc_ops.lsc_planes_plain(*args, **kw),
                           pre_move_lsc_planes(*args, guard_margin=0.004))


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_enumeration_takes_the_first_minimum(dtype, monkeypatch):
    """_closest_point_enum picks torch.argmin's candidate over the subsets
    in order (sizes 1, 2, 3, each in combinations order): the first of
    equal least d2, the first candidate (its non-finite components zeroed)
    when no subset is feasible, and the first NaN d2 of a feasible
    subset.  Three points: 3 + 3 + 1 candidates, no interior test."""
    inf, nan = float("inf"), float("nan")
    d2 = {1: [[5.0, 2.0, 2.0], [1.0, 1.0, 1.0], [3.0, nan, 1.0],
              [4.0, 4.0, 4.0]],
          2: [[2.0, 7.0, 9.0], [1.0, 1.0, 1.0], [nan, 0.5, 0.5],
              [9.0, 9.0, 9.0]],
          3: [[2.0], [1.0], [0.1], [4.0]]}
    feas = {1: [[True] * 3, [False] * 3, [True] * 3, [True, False, True]],
            2: [[True] * 3, [False] * 3, [True] * 3, [True] * 3],
            3: [[True], [False], [True], [True]]}
    cands = {}
    for k, n in ((1, 3), (2, 3), (3, 1)):
        c = torch.arange(4 * n * 3, dtype=dtype).reshape(4, n, 3) + 10 * k
        cands[k] = c
    cands[1][1, 0] = torch.tensor([inf, 2.0, nan], dtype=dtype)

    def fake(points, k):
        return (cands[k], torch.tensor(d2[k], dtype=dtype),
                torch.tensor(feas[k]))
    monkeypatch.setattr(hull, "_solve_subsets", fake)
    closest, dist = hull._closest_point_enum(
        torch.zeros(4, 3, 3, dtype=dtype), 3)
    want = torch.stack([cands[1][0, 1],                  # tie: the first
                        torch.tensor([0.0, 2.0, 0.0], dtype=dtype),
                        cands[1][2, 1],                  # the first NaN
                        cands[1][3, 0]])                 # 1-subset first
    assert torch.equal(closest, want)
    assert same_bits(dist, torch.tensor([2.0, inf, nan, 4.0],
                                        dtype=dtype).sqrt())


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_interior_test_falls_back_to_plus_x(dtype):
    """Six control points around the origin (an octahedron, the relative
    hull of overlapping agents): the closest point is the origin and the
    normal +x exactly, z divided by the downwash too; moved off the
    origin, the same hull gives its own normal.  A skew hull around the
    origin, whose every feasible subset candidate lies off it, is caught
    by the interior test: closest point 0, distance 0."""
    N, O, M, K = 1, 2, 1, 6
    octa = torch.cat([torch.eye(3), -torch.eye(3)]).to(dtype) * 0.3
    obs = torch.stack([-octa, -(octa + torch.tensor([2.0, 0.0, 0.0],
                                                    dtype=dtype))])
    init = torch.zeros(N, M, K, 3, dtype=dtype)
    args = (init, obs.reshape(N, O, M, K, 3),
            torch.full((N,), 0.15, dtype=dtype),
            torch.full((N,), 2.0, dtype=dtype),
            torch.full((N, O), 0.15, dtype=dtype),
            torch.full((N, O), 2.0, dtype=dtype),
            torch.ones(N, O, dtype=torch.bool),
            torch.ones(N, O, dtype=torch.bool))
    got = cons.lsc_planes(*args)
    assert torch.equal(got.normal[0, 0, 0],
                       torch.tensor([1.0, 0.0, 0.0], dtype=dtype))
    assert torch.allclose(got.normal[0, 1, 0],      # the same by geometry
                          torch.tensor([1.0, 0.0, 0.0], dtype=dtype),
                          atol=1e-6)
    rel = obs[0].reshape(K, 3)
    closest, dist = hull.closest_point_to_hull(-rel[None])
    assert torch.equal(closest[0], torch.zeros(3, dtype=dtype))
    assert dist[0] == 0.0
    assert same_planes(got, pre_move_lsc_planes(*args))
    skew = torch.tensor([[1.0, 0.1, 0.2], [-0.4, 1.0, -0.3],
                         [-0.5, -0.9, 0.4], [0.1, 0.2, -1.1],
                         [0.7, -0.6, 0.9], [-0.2, 0.3, 0.8]], dtype=dtype)
    d2 = torch.cat([torch.where(f, d, torch.inf) for _, d, f in (
        hull._solve_subsets(skew[None], k) for k in (1, 2, 3))], dim=-1)
    assert float(d2.min()) > 1e-3
    closest, dist = hull.closest_point_to_hull(skew[None])
    assert torch.equal(closest[0], torch.zeros(3, dtype=dtype))
    assert dist[0] == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_signs_are_the_pre_move_ones(dtype):
    """Negative zeros in the inputs (control points at -0.0, axis-aligned
    hulls with -0.0 components) give the pre-move outputs bit for bit; the
    sums that start from 0 leave no -0.0 in the normals or right-hand
    sides, as before."""
    N, O, M, K = 2, 3, 2, 6
    init = torch.full((N, M, K, 3), -0.0, dtype=dtype)
    obs = torch.zeros(N, O, M, K, 3, dtype=dtype)
    obs[:, 1, :, :, 0] = -2.0                 # (2, -0, -0) relative
    obs[:, 2, :, :, :] = -0.0
    obs[:, 2, :, :, 1] = torch.tensor([1.0, -1.0, 0.5, -0.5, 2.0, -2.0],
                                      dtype=dtype)
    args = (init, obs, torch.full((N,), 0.15, dtype=dtype),
            torch.full((N,), 2.0, dtype=dtype),
            torch.full((N, O), 0.15, dtype=dtype),
            torch.full((N, O), 2.0, dtype=dtype),
            torch.tensor([[True, False, True]] * N),
            torch.ones(N, O, dtype=torch.bool))
    got = cons.lsc_planes(*args, guard_margin=0.004)
    assert same_planes(got, pre_move_lsc_planes(*args, guard_margin=0.004))
    for t in (got.normal, got.rhs):
        assert not bool(torch.signbit(t[t == 0]).any())
    assert torch.equal(got.normal[:, 1, :, 0], torch.ones(N, M,
                                                          dtype=dtype))


def test_hulls_past_eight_points_take_fista(monkeypatch):
    """Nine control points a hull run ops/hull.py's FISTA branch through
    the plain version on any device (a device without a kernel shows the
    routing); eight or fewer on such a device raise."""
    calls = []
    fista = hull._closest_point_fista

    def spy(points, iters=256):
        calls.append(tuple(points.shape))
        return fista(points, iters)
    monkeypatch.setattr(hull, "_closest_point_fista", spy)
    args, kw = lsc_planes_case("random", (3, 4, 2, 9), torch.float64, "cpu")
    got = cons.lsc_planes(*args, **kw)
    assert calls == [(3, 4, 2, 9, 3)]
    assert same_planes(got, pre_move_lsc_planes(*args, **kw))
    meta = [a.to("meta") for a in args]
    assert cons.lsc_planes(*meta).rhs.shape == (3, 4, 2, 9)
    args, _ = lsc_planes_case("random", (3, 4, 2, 8), torch.float64, "cpu")
    with pytest.raises(RuntimeError, match="no kernel"):
        cons.lsc_planes(*[a.to("meta") for a in args])


def test_the_kernel_path_refuses_what_it_cannot_take():
    """The kernel's checks: float32 or float64, every argument on the
    obs_pred's device and broadcastable to its shape."""
    args, kw = lsc_planes_case("slack", (3, 4, 2, 6), torch.float32, "cpu")
    lsc_ops._check(*args, kw["slack_flags"], kw["obs_pred_sizes"])
    with pytest.raises(ValueError, match="dtype"):
        lsc_ops._check(*[a.half() if a.is_floating_point() else a
                         for a in args], None, None)
    bad = list(args)
    bad[4] = bad[4][:, :2]
    with pytest.raises(ValueError, match="obs_radius"):
        lsc_ops._check(*bad, None, None)
    with pytest.raises(ValueError, match="obs_pred_sizes"):
        lsc_ops._check(*args, kw["slack_flags"],
                       kw["obs_pred_sizes"].double())
    bad = list(args)
    bad[6] = bad[6].float()
    with pytest.raises(ValueError, match="obs_is_agent"):
        lsc_ops._check(*bad, None, None)


@pytest.mark.parametrize("slack", [False, True])
def test_the_kernel_path_counts_launches_and_hulls(slack, monkeypatch):
    """The kernel branch, its launch stubbed: one launch counted a call,
    the entry point's arguments as ops/_build.py declares them (the slack
    pointers null without slack), and planes.kernel_hulls = N * O * M
    recorded only while counters are on."""
    launched = []

    def launch(entry, device, *args):
        launched.append((entry, args))
        return 0
    lib = type("Lib", (), {"lsc_planes_f32": "f32", "lsc_planes_f64": "f64"})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "launch", launch)
    N, O, M, K = 3, 4, 2, 6
    args, kw = lsc_planes_case("slack" if slack else "random", (N, O, M, K),
                               torch.float32, "cpu")
    call = (*args, kw.get("slack_flags"), kw.get("obs_pred_sizes"),
            kw.get("guard_margin", 0.0))
    lsc_ops.reset_counts()
    counts = []
    for switch in (None, dict(stamps=True, counters=False),
                   dict(stamps=False, counters=True)):
        with trace.recording("cpu") as rec:
            if switch is None:
                got = lsc_ops._lsc_planes_cuda(*call)
            else:
                with trace.tracing(**switch):
                    got = lsc_ops._lsc_planes_cuda(*call)
        counts.append(rec.counters())
    assert counts[:2] == [{}, {}]
    assert counts[2]["planes.kernel_hulls"].tolist() == [N * O * M]
    assert lsc_ops.lsc_planes_launches == 3
    entry, ptr_args = launched[-1]
    assert entry == "f32"
    assert len(ptr_args) == len(_build._SIGNATURES["lsc_planes_f32"]) - 1
    assert (ptr_args[7] is None) == (ptr_args[8] is None) == (not slack)
    assert ptr_args[9] == kw.get("guard_margin", 0.0)
    assert ptr_args[12:] == (N, O, M, K)
    assert got.normal.shape == (N, O, M, 3) and got.rhs.shape == (N, O, M, K)
    assert torch.equal(got.mask, args[7][..., None].expand(N, O, M))
