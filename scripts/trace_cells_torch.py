#!/usr/bin/env python3
"""The port's tracer on the benchmark's cells, on the card.

    PYTHONPATH=. python3 scripts/trace_cells_torch.py stages CELL [--seed S]
        [--dispatches N] [--out FILE]
    PYTHONPATH=. python3 scripts/trace_cells_torch.py check CELL [--seed S]
        [--out FILE]
    PYTHONPATH=. python3 scripts/trace_cells_torch.py pace CELL [--seed S]
        [--seconds T]
    PYTHONPATH=. python3 scripts/trace_cells_torch.py hostcost CELL [--seed S]

CELL is a cell of BENCHMARK.json (random1024, forest20); the mission, the
Param and the warm-up are the benchmark's (lscbench/cell.py, window.py).

``stages``: an untraced graph warmed as the window warms it, then tracing
on with stamps only (no profiler in the process), a stamped graph from the
same state and N dispatches with the window's read and restart rule: each
dispatch's host wall (replay and read), its device time (first stamp to
END), each stage's device ms and where the device time sits on the host
clock (trace.calibrate).  Prints the stage table a cycle, and for dispatches
slower than the median by 10 % or more, which stages hold the difference.

``check``: from one warm state, 20 dispatches each of graphs captured with
tracing off, with stamps and with counters, every field compared bit for
bit; the counters graph's first cycle's ipm.qp_iters against the fused
call relaunched from the same state (lscbench/probes.py); the graphs' ms a
cycle in turns (CUDA events); then a profiled stretch of the stamped graph
(the last thing in the process: the profiler slows what follows): its
kernels against the untraced graph's, the IPM stage against the IPM
kernels' device ms, and the longest idle gaps named by the program's span
and stage.

``pace``: turns of back-to-back replays of the untraced graph and of a
stamped one for T seconds, nvidia-smi sampled beside them: whether the
card runs the same graph at two paces, and which stages hold the
difference.

``hostcost``: host microseconds of a dispatch call with tracing off
(multi(state) alone, the replay's launch included, median of 200) and of
the tracer's off path a dispatch; runs on a program without a tracer too
(the parent's tree on PYTHONPATH), for the comparison.

Prints a summary on standard output, and with --out FILE writes every
figure to FILE as JSON.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "lscbench"))

import cell as cell_mod  # noqa: E402
import probes  # noqa: E402
import window  # noqa: E402

try:
    from lsc_planner_tpu_torch import trace
except ImportError:         # a program without a tracer (hostcost)
    trace = None

CHOL = ("factor_solve_kernel", "resolve_kernel")


def setup(name, seed):
    """(cell, simulator, initial state, the window graph's multi, the warm
    state): the benchmark's set-up of the cell."""
    c = cell_mod.find(name, ROOT)
    prog = window.default_program()
    arrays = c.mission_arrays(seed)
    mission = cell_mod.build_mission(prog.missions, arrays,
                                     c.config["agent"])
    param = cell_mod.build_param(prog.config, c.config)
    sim = prog.SyncSimulator(mission, param, device="cuda",
                             dtype=getattr(torch, c.config["dtype"]))
    init = sim.initial_state()
    multi = sim.make_scan_cycle(c.k)
    s = init
    for _ in range(1 + int(c.workload.get("warm_dispatches", 0))):
        s, out = multi(s)
        window.read_back(out, c.k)
    torch.cuda.synchronize()
    return c, sim, init, multi, window.clone_state(s)


class Loop:
    """The window's loop: dispatch, one read, the restart rule."""

    def __init__(self, sim, init, k, state):
        self.sim, self.init, self.k = sim, init, k
        self.threshold = float(sim.param.goal_threshold)
        self.cap = int(sim.param.multisim_max_planner_iteration)
        self.state, self.cycles = state, int(state.seq)

    def step(self, multi):
        nxt, out = multi(self.state)
        gd = window.read_back(out, self.k)[0]
        self.cycles += self.k
        if (gd < self.threshold).any() or self.cycles >= self.cap:
            self.state, self.cycles = self.init, 0
        else:
            self.state = nxt
        return nxt, out


def smi():
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


# ------------------------------------------------------------------ stages
def cmd_stages(a):
    c, sim, init, multi, warm = setup(a.cell, a.seed)
    k = c.k
    offset, unc = trace.calibrate("cuda")
    trace.enable(stamps=True)
    loop = Loop(sim, init, k, warm)
    stamped = sim.make_scan_cycle(k)
    rows = []
    for d in range(a.dispatches):
        h0 = time.perf_counter_ns()
        loop.step(stamped)
        h1 = time.perf_counter_ns()
        marks = trace.stamps(stamped.graph)
        by = collections.Counter()
        for stage, s in trace.durations(marks):
            by[stage] += 1e3 * s
        launch = [sp for sp in trace.spans() if sp.name == "graph.replay"][-1]
        # the stage the device was in when the host's launch returned
        at = [st for st, t in marks if trace.to_host_ns(t) <= launch.end_ns]
        rows.append({"d": d, "wall_ms": (h1 - h0) * 1e-6,
                     "launch_ms": launch.seconds * 1e3,
                     "launch_done_in": at[-1] if at else "before",
                     "marks_done_at_launch_end": len(at),
                     "device_ms": (marks[-1][1] - marks[0][1]) * 1e-6,
                     "start_after_call_ms":
                         (trace.to_host_ns(marks[0][1]) - h0) * 1e-6,
                     "read_after_end_ms":
                         (h1 - trace.to_host_ns(marks[-1][1])) * 1e-6,
                     "stage_ms": dict(by)})
    trace.disable()
    rows = rows[1:]                 # the first held the capture
    stages = list(trace.STAGES)
    mean = {s: statistics.fmean(r["stage_ms"].get(s, 0.0) for r in rows) / k
            for s in stages}
    dev = [r["device_ms"] for r in rows]
    med = statistics.median(dev)
    slow = [r for r in rows if r["device_ms"] > 1.1 * med]
    fast = [r for r in rows if r["device_ms"] <= 1.1 * med]

    def per_stage(rs):
        return {s: statistics.fmean(r["stage_ms"].get(s, 0.0) for r in rs)
                for s in stages} if rs else None
    fig = {"cell": a.cell, "seed": a.seed, "smi": smi(),
           "calibration_ns": [offset, unc], "k": k,
           "stage_ms_per_cycle": mean,
           "device_ms_per_cycle": statistics.fmean(dev) / k,
           "wall_ms_per_cycle": statistics.fmean(
               r["wall_ms"] for r in rows) / k,
           "device_ms_a_dispatch_quantiles": statistics.quantiles(dev, n=4),
           "slow_dispatches": len(slow), "fast_dispatches": len(fast),
           "slow_stage_ms_a_dispatch": per_stage(slow),
           "fast_stage_ms_a_dispatch": per_stage(fast),
           "start_after_call_ms_median": statistics.median(
               r["start_after_call_ms"] for r in rows),
           "read_after_end_ms_median": statistics.median(
               r["read_after_end_ms"] for r in rows),
           "launch_ms_median": statistics.median(
               r["launch_ms"] for r in rows),
           "marks_done_at_launch_end_median": statistics.median(
               r["marks_done_at_launch_end"] for r in rows),
           "rows": rows}
    dump(a, fig)
    print(f"{a.cell} seed {a.seed}: {fig['smi']}; calibration +-"
          f"{unc / 1e3:.1f} us")
    print(f"  device {fig['device_ms_per_cycle']:.3f} ms a cycle, wall "
          f"{fig['wall_ms_per_cycle']:.3f}; device start "
          f"{fig['start_after_call_ms_median']:.3f} ms after the replay "
          f"call, read done {fig['read_after_end_ms_median']:.3f} ms after "
          f"END (medians); the host's graph launch "
          f"{fig['launch_ms_median']:.3f} ms, {fig['marks_done_at_launch_end_median']}"
          f" of {len(trace.STAGES) * k + 1} marks passed when it returned")
    for s in stages:
        line = f"  {s:12s} {mean[s]:8.4f} ms/cycle"
        if slow and fast:
            line += (f"   fast {fig['fast_stage_ms_a_dispatch'][s]:9.3f} "
                     f"slow {fig['slow_stage_ms_a_dispatch'][s]:9.3f} "
                     "ms a dispatch")
        print(line)
    print(f"  dispatches: {len(fast)} fast, {len(slow)} slow (device > 1.1 x "
          f"median {med:.2f} ms); quartiles "
          f"{[round(q, 2) for q in fig['device_ms_a_dispatch_quantiles']]}")


# ------------------------------------------------------------------- check
def bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def flat(out):
    state, (info, gd, dist) = out
    return [t for t in (*state, *info, gd, dist) if t is not None]


def cmd_check(a):
    c, sim, init, multi, warm = setup(a.cell, a.seed)
    k, n = c.k, 20
    fig = {"cell": a.cell, "seed": a.seed, "smi": smi(), "k": k}

    # 1. bits: off, stamps, counters from the same warm state
    runs, graphs = {}, {}
    for mode, sw in (("off", None), ("stamps", (True, False)),
                     ("counters", (False, True))):
        if sw:
            trace.enable(*sw)
        m = multi if mode == "off" else sim.make_scan_cycle(k)
        loop = Loop(sim, init, k, window.clone_state(warm))
        outs, counts = [], collections.defaultdict(list)
        for _ in range(n):
            out = loop.step(m)
            outs.append([t.clone() for t in flat(out)])
            for name, v in trace.counters(m.graph).items():
                counts[name].append(v)
            if mode == "stamps":
                ipm_ms = sum(sec for st, sec in trace.durations(
                    trace.stamps(m.graph)) if st == "ipm")
                fig.setdefault("ipm_stage_ms_a_cycle_by_dispatch",
                               []).append(1e3 * ipm_ms / k)
        trace.disable()
        runs[mode], graphs[mode] = (outs, counts), m
    differing = {}
    for mode in ("stamps", "counters"):
        differing[mode] = sum(
            int((bits(x) != bits(y)).sum()) for a_, b_ in
            zip(runs["off"][0], runs[mode][0]) for x, y in zip(a_, b_))
    fig["differing_bits_vs_off"] = differing
    counts = runs["counters"][1]
    fig["counters"] = {name: torch.cat([v.reshape(-1).double()
                                        for v in vs]).mean().item()
                       for name, vs in counts.items()}
    if "ipm.iters_run" in counts:
        extra = sum(float((r.double() - v.double()).sum()) for r, v in
                    zip(counts["ipm.iters_run"],
                        counts["ipm.iters_converged"]))
        fig["ipm_iters_after_converged"] = extra / (n * k)
        conv = torch.cat([v.reshape(-1) for v in
                          counts["ipm.iters_converged"]]).double()
        fig["iters_converged_quantiles"] = [
            float(q) for q in torch.quantile(conv, torch.tensor(
                [0.0, 0.25, 0.5, 0.75, 1.0], dtype=torch.float64))]
    # 2. the first cycle's per-QP counts against the relaunched fused call
    if "ipm.qp_iters" in counts:
        ctx = types.SimpleNamespace(sim=sim, state=window.clone_state(warm),
                                    program=window.default_program(),
                                    device=torch.device("cuda"), k=k,
                                    cache={})
        call = probes.fused_call(ctx)
        first = counts["ipm.qp_iters"][0][0].to(torch.int64)
        fig["qp_iters_first_cycle_equal_fused_call"] = bool(torch.equal(
            first, call["qp_iters"].to(torch.int64)))
        fig["ipm_qp_iters_stretch"] = fig["counters"]["ipm.qp_iters"]
        fig["fused_call_iters_mean"] = float(call["qp_iters"].mean())

    # 3. ms a cycle of each graph, in turns (CUDA events, 5 replays a turn)
    state = {mode: window.clone_state(warm) for mode in graphs}
    times = collections.defaultdict(list)
    order = ["off", "stamps", "counters", "counters", "stamps", "off"] * 3
    for mode in order:
        g = graphs[mode].graph
        g(state[mode])
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        for _ in range(5):
            g(g.static)
        e1.record()
        e1.synchronize()
        times[mode].append(e0.elapsed_time(e1) / (5 * k))
    fig["graph_ms_per_cycle"] = {m: sorted(v) for m, v in times.items()}
    fig["graph_ms_per_cycle_median"] = {m: statistics.median(v)
                                        for m, v in times.items()}

    # 4. a profiled stretch of the stamped graph (3 dispatches) and one
    #    replay of the untraced graph
    trace.enable(stamps=True)
    stamped = graphs["stamps"]
    loop = Loop(sim, init, k, window.clone_state(warm))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("stretch"):
            for _ in range(3):
                with trace.span("dispatch"):
                    loop.step(stamped)
        torch.cuda.synchronize()
    stage_marks = stamped.graph.trace.stages
    trace.disable()
    with torch.profiler.profile(activities=acts) as prof_off:
        multi.graph(window.clone_state(warm))
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof_on:
        stamped.graph(window.clone_state(warm))
        torch.cuda.synchronize()

    def by_key(p):
        return {e.key: e.count for e in p.key_averages()
                if str(e.device_type).endswith("CUDA")}
    off_k, on_k = by_key(prof_off), by_key(prof_on)
    stamp_keys = [key for key in on_k if "stamp_kernel" in key]
    stamps_counted = sum(on_k.pop(key) for key in stamp_keys)
    fig["profiled_replay"] = {
        "stamp_kernels": stamps_counted, "marks": len(stage_marks),
        "other_kernels_equal_untraced": on_k == off_k,
        "kernels_untraced": sum(off_k.values()),
        "kernels_stamped_without_stamps": sum(on_k.values())}
    fig.update(reduce_profile(prof, stage_marks, 3 * k))
    # the same 3 dispatches without the profiler (the bits phase's first)
    fig["ipm_stage_ms_first_3_dispatches_unprofiled"] = statistics.fmean(
        fig["ipm_stage_ms_a_cycle_by_dispatch"][:3])
    dump(a, fig)
    print(json.dumps({key: v for key, v in fig.items()
                      if key not in ("gaps",)}, indent=1, default=str))
    for g in fig["gaps"][:12]:
        print("  gap", g)


def reduce_profile(prof, stage_marks, cycles):
    """Device ms a cycle by stage (the stamp kernels' times), the IPM and
    chol kernels' device ms a cycle, and the longest idle gaps, each named
    by the innermost lsc. span and the stage it fell in."""
    dev, stamps, host = [], [], []
    ipm_us = chol_us = 0.0
    for e in prof.events():
        tr = getattr(e, "time_range", None)
        if tr is None:
            continue
        on_dev = str(getattr(e, "device_type", "")).endswith("CUDA")
        if e.name.startswith(trace.SPAN_PREFIX):
            if not on_dev:
                host.append((tr.start, tr.end, e.name))
            continue
        if not on_dev:
            continue
        dev.append((tr.start, tr.end))
        if "stamp_kernel" in e.name:
            stamps.append(tr.start)
        elif "ipm_kernel" in e.name:
            ipm_us += tr.end - tr.start
        elif any(f"::{c}" in e.name for c in CHOL):
            chol_us += tr.end - tr.start
    stamps.sort()
    per = len(stage_marks)
    stage_of = [stage_marks[i % per] for i in range(len(stamps))]
    stage_us = collections.Counter()
    for i in range(len(stamps) - 1):
        if stage_of[i] != trace.END:
            stage_us[stage_of[i]] += stamps[i + 1] - stamps[i]
    dev.sort()
    merged = []
    for a_, b_ in dev:
        if merged and a_ <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b_)
        else:
            merged.append([a_, b_])
    gaps = []
    host.sort(key=lambda h: h[1] - h[0])
    for (_, a_), (b_, _) in zip(merged, merged[1:]):
        if b_ <= a_:
            continue
        j = max((i for i, t in enumerate(stamps) if t <= a_), default=None)
        stage = stage_of[j] if j is not None else "before"
        span = next((h[2][len(trace.SPAN_PREFIX):] for h in host
                     if h[0] <= a_ < h[1]), "outside")
        gaps.append((round((b_ - a_) * 1e-3, 4), span, stage))
    gaps.sort(key=lambda g: -g[0])
    by = collections.Counter()
    for ms, span, stage in gaps:
        by[f"{span}/{stage}"] += ms
    return {"profiled_stage_ms_per_cycle": {s: v * 1e-3 / cycles
                                            for s, v in stage_us.items()},
            "ipm_kernel_ms_per_cycle": ipm_us * 1e-3 / cycles,
            "chol_kernels_ms_per_cycle": chol_us * 1e-3 / cycles,
            "gaps": gaps[:40],
            "gap_ms_by_span_and_stage": {key: round(v, 3) for key, v in
                                         by.most_common()}}


# ------------------------------------------------------------------- pace
def smi_sampler(samples, stop):
    """nvidia-smi's clocks, power and throttle reasons every 0.2 s."""
    import subprocess
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "clocks_throttle_reasons.active", "--format=csv,noheader",
         "-lms", "200"], stdout=subprocess.PIPE, text=True)
    for line in proc.stdout:
        samples.append((time.perf_counter(), line.strip()))
        if stop.is_set():
            break
    proc.terminate()


def cmd_pace(a):
    """Turns of 5 back-to-back replays (no read between them) of the
    untraced graph and of a stamped one, for --seconds: each turn's ms a
    cycle (CUDA events), the stamped turns' stage ms of their last replay,
    nvidia-smi's clocks beside them; the turns split at the middle of the
    range of their ms a cycle when it spans more than 5 %."""
    import threading
    c, sim, init, multi, warm = setup(a.cell, a.seed)
    k = c.k
    trace.enable(stamps=True)
    stamped = sim.make_scan_cycle(k)
    stamped(window.clone_state(warm))
    trace.disable()
    graphs = {"off": multi.graph, "stamps": stamped.graph}
    for g in graphs.values():
        g(window.clone_state(warm))
    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=smi_sampler, args=(samples, stop),
                               daemon=True)
    sampler.start()
    turns = []
    t_end = time.perf_counter() + a.seconds
    while time.perf_counter() < t_end:
        for mode, g in graphs.items():
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            for _ in range(5):
                g(g.static)
            e1.record()
            e1.synchronize()
            turn = {"mode": mode, "t": t0, "ms": e0.elapsed_time(e1) / (5 * k)}
            if mode == "stamps":
                by = collections.Counter()
                for st, sec in trace.durations(trace.stamps(g)):
                    by[st] += 1e3 * sec
                turn["stage_ms"] = dict(by)
            turns.append(turn)
    stop.set()
    ms = [t["ms"] for t in turns]
    cut = 0.5 * (min(ms) + max(ms))
    bimodal = max(ms) > 1.05 * min(ms)
    fig = {"cell": a.cell, "seed": a.seed, "k": k, "cut_ms": cut,
           "bimodal": bimodal, "turns": turns, "smi": samples}
    for mode in graphs:
        for pace, keep in (("fast", lambda x: x <= cut),
                           ("slow", lambda x: x > cut)):
            sel = [t for t in turns if t["mode"] == mode and keep(t["ms"])]
            fig[f"{mode}_{pace}"] = {
                "turns": len(sel),
                "ms_per_cycle": statistics.median(t["ms"] for t in sel)
                if sel else None}
            if mode == "stamps" and sel:
                fig[f"{mode}_{pace}"]["stage_ms_a_dispatch"] = {
                    st: statistics.median(t["stage_ms"].get(st, 0.0)
                                          for t in sel)
                    for st in trace.STAGES}
    # the pace of each turn in order, and the smi samples around switches
    seq = "".join("S" if t["ms"] > cut else "f" for t in turns)
    fig["sequence"] = seq
    dump(a, fig)
    print(f"{a.cell} seed {a.seed}: {len(turns)} turns, bimodal {bimodal}, "
          f"cut {cut:.3f} ms/cycle; sequence {seq}")
    for key in ("off_fast", "off_slow", "stamps_fast", "stamps_slow"):
        print(f"  {key}: {json.dumps(fig[key])}")
    kinds = collections.Counter(
        tuple(f.strip() for i, f in enumerate(line.split(",")) if i != 2)
        for _, line in samples)
    print(f"  smi samples (clocks.sm, clocks.mem, throttle reasons): "
          f"{kinds.most_common(6)}")


# --------------------------------------------------------------- hostcost
def cmd_hostcost(a):
    c, sim, init, multi, warm = setup(a.cell, a.seed)
    k = c.k
    s = warm
    calls = []
    for _ in range(200):
        t0 = time.perf_counter_ns()
        s, out = multi(s)
        calls.append((time.perf_counter_ns() - t0) * 1e-3)
        window.read_back(out, k)
    fig = {"cell": a.cell, "tracer": trace is not None, "smi": smi(),
           "dispatch_call_us_median": statistics.median(calls),
           "dispatch_call_us_quartiles": statistics.quantiles(calls, n=4)}
    if trace is not None:
        reps = 100000
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            trace.graph_key()
            with trace.span("graph.replay"):
                pass
        fig["off_path_us_a_dispatch"] = (time.perf_counter_ns() - t0) * 1e-3 \
            / reps
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            trace.mark("planes")
        fig["off_mark_us"] = (time.perf_counter_ns() - t0) * 1e-3 / reps
    dump(a, fig)
    print(json.dumps(fig))


def dump(a, fig):
    if a.out:
        out = Path(a.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(fig, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", choices=("stages", "check", "pace", "hostcost"))
    ap.add_argument("cell")
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--dispatches", type=int, default=60)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    {"stages": cmd_stages, "check": cmd_check, "pace": cmd_pace,
     "hostcost": cmd_hostcost}[a.cmd](a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
