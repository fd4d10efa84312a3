"""The program's own trace after the window of a traced run, read by the
per-layer metrics whose ``probe(ctx)`` calls ``run``; the result is kept in
``ctx.cache``, so they share one.

With the program's tracer (``<package>.trace``): the window graph's set-up
spans (graph.warm_up, graph.capture: the first graph the process
captured), then tracing on with stage stamps only, a graph of k cycles
captured from ``ctx.state`` and ``DISPATCHES`` dispatches (``CPU_DISPATCHES``
on the CPU, whose cycles take a thousand times the card's) replayed with the
window's read and restart rule, the stamps and the graph.replay spans read
after each; then the same with counters only (a graph of its own from the
same state); then tracing off.  Counters may add device work, stamps one
launch a mark, so stage times come from the stamps-only graph.  A program
without a tracer (an older one) gives None, and the readers None.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import time

import window

DISPATCHES = 20
CPU_DISPATCHES = 2


@dataclasses.dataclass
class Result:
    stage_ms: dict          # {stage: device ms a cycle} of the stamps graph
    cycles: int             # cycles each stretch ran
    counters: dict          # {name: [stacked values of each dispatch]}
    replay_ms: list         # graph.replay host spans of the stamps stretch
    setup_graph_s: float    # the window graph's warm-up and capture


def tracer(program):
    """The program's trace module, or None when it has none."""
    try:
        return importlib.import_module(f"{program.package.__name__}.trace")
    except ModuleNotFoundError:
        return None


def run(ctx):
    if "program_trace" not in ctx.cache:
        tr = tracer(ctx.program)
        ctx.cache["program_trace"] = None if tr is None else _run(ctx, tr)
    return ctx.cache["program_trace"]


def _run(ctx, tr):
    setup = {}
    for s in tr.spans():
        if s.name in ("graph.warm_up", "graph.capture"):
            setup.setdefault(s.name, s.seconds)
    init = ctx.sim.initial_state()
    try:
        tr.enable(stamps=True, counters=False)
        stage_s, _, replay_ms, cycles = _stretch(ctx, tr, init)
        tr.enable(stamps=False, counters=True)
        _, counters, _, _ = _stretch(ctx, tr, init)
    finally:
        tr.disable()
    return Result(stage_ms={k: 1e3 * v / cycles for k, v in stage_s.items()},
                  cycles=cycles, counters=counters, replay_ms=replay_ms,
                  setup_graph_s=(sum(setup.values()) if len(setup) == 2
                                 else None))


def _stretch(ctx, tr, init):
    """DISPATCHES (on the CPU CPU_DISPATCHES) dispatches from ctx.state
    under the switch set: (seconds by stage, {counter: [values a
    dispatch]}, graph.replay ms, cycles)."""
    n = DISPATCHES if ctx.device.type == "cuda" else CPU_DISPATCHES
    k, p = ctx.k, ctx.sim.param
    threshold = float(p.goal_threshold)
    cap = int(p.multisim_max_planner_iteration)
    multi = ctx.sim.make_scan_cycle(k)
    state = window.clone_state(ctx.state)
    mission_cycles = int(state.seq)
    stage_s = collections.Counter()
    counters = collections.defaultdict(list)
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tr.recording(ctx.device) as rec:
            nxt, out = multi(state)
        gd = window.read_back(out, k)[0]
        src = getattr(multi, "graph", None) or rec
        for stage, seconds in tr.durations(tr.stamps(src)):
            stage_s[stage] += seconds
        for name, value in tr.counters(src).items():
            counters[name].append(value)
        mission_cycles += k
        if (gd < threshold).any() or mission_cycles >= cap:
            state, mission_cycles = init, 0
        else:
            state = nxt
    replay_ms = [1e3 * s.seconds for s in tr.spans()
                 if s.name == "graph.replay" and s.start_ns >= t0]
    return stage_s, dict(counters), replay_ms, n * k


def result(rec):
    """The program trace a traced run's probes gathered, or None."""
    return next((v for v in rec.probes.values() if isinstance(v, Result)),
                None)


def stage_ms(rec, *stages):
    """Device ms a cycle of `stages` together; None without a trace."""
    r = result(rec)
    if r is None or not any(s in r.stage_ms for s in stages):
        return None
    return sum(r.stage_ms.get(s, 0.0) for s in stages)
