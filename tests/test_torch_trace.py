"""The port's tracer (lsc_planner_tpu_torch/trace.py): the switch, host
spans, stage stamps and the IPM's counters.

CPU tests (the port on device="cpu", where a stamp is the host clock):
  * tracing off leaves no span but the set-up's, and span/mark/count
    allocate nothing;
  * tracing on (stamps and counters) leaves every state field and stacked
    output bit for bit as tracing off does, over two dispatches of k = 2
    cycles on a tiny empty world and a tiny forest;
  * the stage marks come in trace.STAGES' order, a cycle after a cycle,
    then END, and their durations tile the dispatch;
  * iters_converged on the dense path (no exit; the tolerances count
    only) equals the factored path's it_used (the exit) on the same QP;
    the fused IPM's per-QP counts are its qp_counts;
  * spans nest with their names, and are record_function ranges under a
    profiler only while tracing is on.
The card's tests import no JAX and run with
    python -m pytest --noconftest -q -m cuda tests/test_torch_trace.py
"""
import time
import tracemalloc

import numpy as np
import pytest
import torch

from lsc_planner_tpu_torch import trace
from lsc_planner_tpu_torch import missions as tmis
from lsc_planner_tpu_torch.config import GoalMode, Param, PlannerMode
from lsc_planner_tpu_torch.ops import ipm, qp
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator
from test_torch_cuda import CORRIDOR_WORLD, factored_problem, forest_mission

@pytest.fixture(autouse=True)
def quiet_tracer():
    """One torch thread; the tracer off and empty before and after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()
    torch.set_num_threads(threads)


def tiny(kind, device="cpu", dtype=torch.float64):
    if kind == "empty":
        m = tmis.make_circle_mission(4, radius=2.0,
                                     world=(-4, -4, 0, 4, 4, 2.5))
        p = Param(goal_mode=GoalMode.PRIOR_BASED, qp_iterations=12)
    else:
        m = forest_mission(tmis, 3, 4, 12, CORRIDOR_WORLD)
        p = Param(goal_mode=GoalMode.PRIOR_BASED)
    return SyncSimulator(m, p, device=device, dtype=dtype)


def bits(t):
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def flat(out):
    """Every tensor of a dispatch's result (state, (info, gd, dist))."""
    state, (info, gd, dist) = out
    return [t for t in (*state, *info, gd, dist) if t is not None]


def dispatches(sim, multi, n):
    """Every tensor of n dispatches from the initial state, cloned."""
    s, outs = sim.initial_state(), []
    for _ in range(n):
        s, rest = multi(s)
        outs.append([t.clone() for t in flat((s, rest))])
    return outs


def test_off_leaves_no_spans_and_allocates_nothing():
    sim = tiny("empty")
    sim.run(max_iterations=2)
    sim.run(max_iterations=4, steps_per_dispatch=2)
    assert {s.name for s in trace.spans()} == {"sim.tables"}
    assert trace.graph_key() is None
    assert trace.span("a") is trace.span("b")
    x = torch.ones(3)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("run.dispatch"):
                trace.mark("planes")
                trace.count("ipm.iters_run", x)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert not grown, grown


@pytest.mark.parametrize("kind", ["empty", "forest"])
def test_on_leaves_the_states_bit_identical(kind):
    sim = tiny(kind)
    multi = sim.make_scan_cycle(2)
    want = dispatches(sim, multi, 2)
    with trace.tracing(stamps=True, counters=True), \
            trace.recording("cpu") as rec:
        got = dispatches(sim, multi, 2)
    assert len(rec.stages) == 2 * (2 * len(trace.STAGES) + 1)
    assert set(trace.counters(rec)) == {"ipm.iters_converged",
                                        "ipm.iters_run"}
    for a, b in zip(want, got):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(bits(x), bits(y))


@pytest.mark.parametrize("kind", ["empty", "forest"])
def test_stage_marks_come_in_order_and_tile_the_cycle(kind):
    sim = tiny(kind)
    multi = sim.make_scan_cycle(2)
    with trace.tracing(stamps=True), trace.recording("cpu") as rec:
        dispatches(sim, multi, 1)
    marks = trace.stamps(rec)
    assert [s for s, _ in marks] == list(trace.STAGES) * 2 + [trace.END]
    times = [t for _, t in marks]
    assert times == sorted(times)
    spent = trace.durations(marks)
    assert len(spent) == 2 * len(trace.STAGES)
    assert sum(s for _, s in spent) == pytest.approx(
        (times[-1] - times[0]) * 1e-9, rel=1e-9)


@pytest.mark.parametrize("goal_mode", [GoalMode.STATIC, GoalMode.ORCA])
def test_orca_cycle_takes_the_marks_that_apply(goal_mode):
    m = tmis.make_circle_mission(4, radius=2.0, world=(-4, -4, 0, 4, 4, 2.5))
    sim = SyncSimulator(m, Param(planner_mode=PlannerMode.ORCA,
                                 goal_mode=goal_mode), device="cpu",
                        dtype=torch.float64)
    with trace.tracing(stamps=True), trace.recording("cpu") as rec:
        sim.cycle(sim.initial_state())
    want = (["propagate", "goal", "audit"] if goal_mode == GoalMode.ORCA
            else ["propagate", "goal", "planes", "audit"])
    assert rec.stages == want


def dense_problem(seed, N=5, nv=8, R=30):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(N, nv, nv)) * 0.3
    P = L @ np.swapaxes(L, -1, -2) + 2.0 * np.eye(nv)
    A = rng.normal(size=(N, R, nv))
    b = rng.normal(size=(N, R)) - 2.0
    y0 = rng.normal(size=(N, nv)) * 0.1
    return [torch.as_tensor(a) for a in (P, rng.normal(size=(N, nv)), A, b,
                                         y0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iters_converged_on_the_dense_path_equals_the_exit(seed):
    """The dense solve counts by the exit test without taking it; the exit
    (_ipm with the tolerances, as on the factored path) stops at it_used:
    the same QP, rows equilibrated as solve_qp does, the warm start's
    delta coordinates as solve_qp takes them."""
    P, q, A, b, y0 = dense_problem(seed)
    tols = dict(tol_gap=1e-3, tol_rp=1e-4, tol_rd=0.05, tol_step=0.0)
    with trace.tracing(stamps=False, counters=True), \
            trace.recording("cpu") as rec:
        dense = qp.solve_qp(P, q, A, b, y0=y0, iters=40, correctors=1,
                            count_tol=tuple(tols.values()))
    counts = trace.counters(rec)
    A_e, b_e = qp._equilibrate_rows(A, b)
    exit_sol = qp._ipm(
        P, q + qp._matvec(P, y0), lambda y: (A_e @ y[..., None])[..., 0],
        lambda w: (A_e.mT @ w[..., None])[..., 0],
        lambda d: A_e.mT @ (A_e * d[..., None]),
        b_e - (A_e @ y0[..., None])[..., 0], None, 40, 1e-8, 1.0,
        tol_scale=qp._objective_sigma(P), correctors=1, **tols)
    assert 1 < int(exit_sol.iters) < 40
    assert counts["ipm.iters_converged"].tolist() == [int(exit_sol.iters)]
    assert counts["ipm.iters_run"].tolist() == [40]
    # the count leaves the dense solve's iterate as it is
    plain = qp.solve_qp(P, q, A, b, y0=y0, iters=40, correctors=1,
                        count_tol=tuple(tols.values()))
    assert torch.equal(plain.y, dense.y)


def test_factored_and_fused_counters():
    """The factored path counts its it_used and the iterations its early
    exit ran; the fused IPM (plain version) its per-QP counts."""
    args, kw = factored_problem(np.random.default_rng(4), 6, 3,
                                torch.float64, torch.device("cpu"))
    kw["tol_gap"] = 1e-3
    with trace.tracing(stamps=False, counters=True), \
            trace.recording("cpu") as rec:
        sol = qp.solve_qp_lsc(*args, **kw)
    counts = trace.counters(rec)
    assert counts["ipm.iters_converged"].tolist() == [int(sol.iters)]
    run = int(counts["ipm.iters_run"][0])
    assert sol.iters <= run <= 40 and run % qp.EXIT_CHECK_EVERY == 0
    args = [a.float() if a.is_floating_point() else a for a in args]
    kw["y0"] = kw["y0"].float()
    kw["static_blocks"] = tuple(t.float() if t.is_floating_point() else t
                                for t in kw["static_blocks"])
    nf = args[0].shape[-1] // 3
    with trace.tracing(stamps=False, counters=True), \
            trace.recording("cpu") as rec:
        sol = qp.solve_qp_lsc(*args, **kw, P_blk=args[0][:, :nf, :nf],
                              fused_mode="on")
    per_qp = trace.counters(rec)["ipm.qp_iters"]
    assert per_qp.shape == (1, 6)
    assert torch.equal(ipm.tile_counts(per_qp[0]), sol.iters)


def test_spans_nest_with_their_names():
    with trace.tracing(stamps=False):
        with trace.span("outer"):
            with trace.span("inner"):
                time.sleep(0.001)
            with trace.setup_span("graph.capture"):
                pass
        sim = tiny("empty")
        sim.run(max_iterations=4, steps_per_dispatch=2)
    got = {s.name: s for s in trace.spans()}
    assert got["inner"].parent == "outer" and got["outer"].parent is None
    assert got["graph.capture"].parent == "outer"
    assert got["outer"].start_ns <= got["inner"].start_ns < \
        got["inner"].end_ns <= got["outer"].end_ns
    assert got["inner"].seconds >= 0.001
    run = [s.name for s in trace.spans() if s.name.startswith("run.")]
    assert run == ["run.dispatch", "run.read"] * 2
    assert trace.last_seconds("sim.tables") > 0
    assert trace.last_seconds("nothing") is None


@pytest.mark.parametrize("on", [False, True])
def test_spans_are_profiler_ranges_only_while_on(on):
    sim = tiny("empty")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if on:
            with trace.tracing(stamps=True):
                sim.run(max_iterations=2, steps_per_dispatch=2)
        else:
            sim.run(max_iterations=2, steps_per_dispatch=2)
    names = {e.name for e in prof.events()
             if e.name.startswith(trace.SPAN_PREFIX)}
    assert names == ({"lsc.run.dispatch", "lsc.run.read"} if on else set())


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_trace.py")
    return torch.device("cuda")


def traced_graphs(sim, k, n):
    """The untraced graph of k cycles, one with stamps and one with
    counters, n dispatches of each from the initial state: (graphs, the
    dispatches' tensors)."""
    multi = sim.make_scan_cycle(k)
    runs = {"off": dispatches(sim, multi, n)}
    graphs = {"off": multi.graph}
    for mode, switch in (("stamps", (True, False)),
                         ("counters", (False, True))):
        with trace.tracing(*switch):
            runs[mode] = dispatches(sim, multi, n)
            graphs[mode] = multi.graph
    return graphs, runs


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["empty", "forest"])
def test_traced_graphs_are_bit_identical_on_the_card(cuda, kind):
    """Graphs captured with stamps, and with counters, replay the untraced
    graph's bits; the stamped graph's replay writes one distinct,
    increasing stamp a mark."""
    k = 4
    graphs, runs = traced_graphs(tiny(kind, cuda, torch.float32), k, 3)
    assert len({id(g) for g in graphs.values()}) == 3
    for mode in ("stamps", "counters"):
        for a, b in zip(runs["off"], runs[mode]):
            for x, y in zip(a, b):
                assert torch.equal(bits(x), bits(y)), mode
    marks = trace.stamps(graphs["stamps"])
    assert [s for s, _ in marks] == list(trace.STAGES) * k + [trace.END]
    times = [t for _, t in marks]
    assert times == sorted(set(times))
    assert trace.counters(graphs["counters"])["ipm.iters_run"].shape == (k,)
    assert trace.stamps(graphs["off"]) == []


@pytest.mark.cuda
def test_stamped_graph_profiles_as_the_untraced_plus_stamps(cuda):
    """A profiled replay of the stamped graph has the untraced graph's
    kernels, key for key and count for count, and one stamp kernel a mark.
    On the tiny empty world: of the tiny forest's ~38,000 kernel records a
    replay the profiler loses a few, a different number each time, even
    of the untraced graph alone (the full-size cells are compared by
    scripts/trace_cells_torch.py check)."""
    sim = tiny("empty", cuda, torch.float32)
    k = 4
    graphs, _ = traced_graphs(sim, k, 1)

    def kernels(graph):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            # the inputs' copies first, as a dispatch makes them
            graph(sim.initial_state())
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")}
    base, with_stamps = kernels(graphs["off"]), kernels(graphs["stamps"])
    stamp_keys = [key for key in with_stamps if "stamp_kernel" in key]
    assert len(stamp_keys) == 1
    assert with_stamps.pop(stamp_keys[0]) == len(trace.STAGES) * k + 1
    assert with_stamps == base


@pytest.mark.cuda
def test_calibrate_puts_stamps_on_the_host_clock(cuda):
    offset, unc = trace.calibrate(cuda)
    assert 0 <= unc < 1_000_000
    rec = trace.Recording(cuda)
    torch.cuda.synchronize()
    h0 = time.perf_counter_ns()
    rec.mark("x")
    torch.cuda.synchronize()
    h1 = time.perf_counter_ns()
    t = trace.to_host_ns(trace.stamps(rec)[0][1])
    assert h0 - 2 * unc - 50_000 <= t <= h1 + 2 * unc + 50_000
