#!/usr/bin/env python3
"""Profile the port's forest20 cycle on one CUDA GPU.

    python3 scripts/profile_forest20_torch.py [--warm 20] [--cycles 3]
    python3 scripts/profile_forest20_torch.py --captured [--warm 20]
    python3 scripts/profile_forest20_torch.py --kernels

Builds chip_smoke.py's forest20 (20 agents, 60 tree columns, seed 0) on
the card, runs --warm cycles, then traces --cycles cycles with
torch.profiler (CPU + CUDA).  Prints, as one JSON line: the card's name
and power limit, wall ms a cycle of the same cycles run twice from the same
state (host clock, synchronised): once untraced and once under the
profiler, which slows the host; kernel launches and memory copies/sets a
cycle; device-busy ms a cycle (the sum of the device time of both) and its
share of the untraced wall time; the ten kernels with the most device
time; and each of the port's own kernels' device us a launch and
launches a cycle.  Fails when the trace
holds no device time.

With --captured the same JSON line also holds, under "captured", the
same cycles run several a dispatch (make_scan_cycle(10): one CUDA graph
of 10 cycles, replayed): the capture-plus-instantiate seconds, the kernel
launches in a block (the launch counters' increase during capture), wall
ms a cycle over three untraced replays, and from one traced replay the
kernel launches and device-busy ms a cycle and the device-busy share of
the untraced wall time, and the port's own kernels' device us a launch;
beside them the device ms a cycle of a replay timed with CUDA events
(busy and idle time on the stream).

With --kernels it times the chol kernels instead: the chol-path IPM's
two at the main path's shape (B = 64, n = 39, f32, IPM-like systems), the
factor alone (cholesky_batched) at the same shape, factor_solve and the
factor alone at the fused IPM's batch of circle1024 (B = 1024, names
ending in _b1024), the face expansion on forest20's cycle-4 call
(expand_boxes_forest20), the wavefront kernel on forest20's cycle-4
priority grids (N = 20, (11, 41, 41)) and on chip_smoke's 30 m forest
((21, 121, 121)), and the LSC planes kernel on the cycle-4 calls of
forest20 ((20, 20, 5, 6)) and of the benchmark's random1024 ((1024, 32,
5, 6)), through constraints.lsc_planes, and prints as one
JSON line: each wrapper's device us a launch (200 launches captured in
one CUDA graph, 20 for the wavefront, the face expansion and random1024's
planes, replayed, CUDA events over the replay / launches: no host time),
its host us a call (2,000 calls enqueued without a synchronize, 200 for
those three) and its
CUDA-event us a call (median of 50, as chip_smoke phase 4); and the host
us of reading the current stream with a device guard and
torch.cuda.current_stream against the raw stream (ops/_build.py::launch).
Each number is the least of three rounds.  Imports nothing of JAX.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from chip_smoke import CAPTURE_K  # noqa: E402
from lsc_planner_tpu_torch import GoalMode, Param, trace  # noqa: E402
from lsc_planner_tpu_torch.ops import chol, wavefront  # noqa: E402
from lsc_planner_tpu_torch.ops import corridor as corridor_ops  # noqa: E402
from lsc_planner_tpu_torch.planner import constraints  # noqa: E402
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator  # noqa: E402


def device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def graph_us(fn, n=200):
    """Device us a call of fn: n calls in one CUDA graph, replayed."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / n


def host_us(fn, n=2000):
    """Host us a call of fn, the calls enqueued without a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def time_kernels(smi):
    dev = torch.device("cuda", torch.cuda.current_device())
    Hs, r1, r2 = chip_smoke.ipm_like_system(chip_smoke.MAIN_B,
                                            chip_smoke.N_QP, 0)
    H, R1, R2 = (torch.as_tensor(a, device=dev, dtype=torch.float32)
                 for a in (Hs, r1, r2))
    L = chol.chol_factor_solve(H, R1)[0]
    Hs, r1, _ = chip_smoke.ipm_like_system(chip_smoke.BIG_N,
                                           chip_smoke.N_QP, 0)
    Hb, Rb = (torch.as_tensor(a, device=dev, dtype=torch.float32)
              for a in (Hs, r1))
    calls = {"factor_solve": lambda: chol.chol_factor_solve(H, R1),
             "resolve": lambda: chol.chol_resolve(L, R2),
             "cholesky_batched": lambda: chol.cholesky_batched(H),
             "factor_solve_b1024": lambda: chol.chol_factor_solve(Hb, Rb),
             "cholesky_batched_b1024": lambda: chol.cholesky_batched(Hb)}
    forest = SyncSimulator(chip_smoke.forest_mission(),
                           Param(goal_mode=GoalMode.PRIOR_BASED), device=dev)
    grids = {"wavefront_forest20": chip_smoke.capture_wavefront_calls(
        forest, 3)[0], "wavefront_forest30":
        chip_smoke.forest30_static_grids(dev)}
    for name, (occ, goal, cap) in grids.items():
        calls[name] = (lambda occ=occ, goal=goal, cap=cap:
                       wavefront.wavefront_batched_steps(occ, goal, cap))
    expand = chip_smoke.capture_expand_call(forest, 3)
    calls["expand_boxes_forest20"] = lambda: corridor_ops.expand_boxes(
        *expand)
    for name, sim in (("lsc_planes_forest20", forest),
                      ("lsc_planes_random1024",
                       chip_smoke.random1024_sim(dev))):
        args, kw = chip_smoke.capture_planes_call(sim, 3)
        calls[name] = (lambda args=args, kw=kw:
                       constraints.lsc_planes(*args, **kw))
    # launches a graph and host-timed calls: fewer for the wavefront,
    # whose launches are longer and whose outputs (held by the graph) are
    # up to 25 MB, for the face expansion, whose launches are longer, and
    # for random1024's planes (6 MB of outputs a call)
    counts = {name: (20, 200) if name in grids or name.startswith(
        ("expand", "lsc_planes_random")) else (200, 2000) for name in calls}

    def guarded():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream
    lookups = {"device_guard_and_current_stream": guarded,
               "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
                   dev.index)}
    best = {}
    for _ in range(3):
        for name, fn in calls.items():
            n_graph, n_host = counts[name]
            got = (graph_us(fn, n_graph), host_us(fn, n_host),
                   1e3 * chip_smoke.median_ms(fn))
            best[name] = [min(x, y) for x, y in
                          zip(best.get(name, got), got)]
        for name, fn in lookups.items():
            best[name] = min(best.get(name, math.inf), host_us(fn))
    print(json.dumps({
        "card": smi, "B": chip_smoke.MAIN_B, "n": chip_smoke.N_QP,
        "us_a_call": {name: dict(zip(("device", "host", "event"),
                                     best[name])) for name in calls},
        "stream_lookup_host_us": {name: best[name] for name in lookups},
    }), flush=True)


def trace(fn, cycles):
    """The device events of the profiler's trace of fn, and its per-cycle
    figures: kernel launches, copies and sets, device-busy ms, and each of
    the port's own kernels' device us a launch and launches a cycle."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    device = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    copies = [e for e in device if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in device if e not in copies]
    busy_us = sum(device_us(e) for e in device)
    return device, {
        "kernel_launches_per_cycle": sum(e.count for e in kernels) / cycles,
        "copies_and_sets_per_cycle": sum(e.count for e in copies) / cycles,
        "device_busy_ms_per_cycle": busy_us / 1e3 / cycles,
        # the port's own kernels (csrc/*.cu, in anonymous namespaces)
        "own_kernels_us_per_launch_and_launches_per_cycle": {
            e.key.split("::", 1)[1].split("(")[0]: [
                device_us(e) / e.count, e.count / cycles]
            for e in kernels if e.key.removeprefix("void ").startswith(
                "(anonymous namespace)::")}}


def captured_figures(sim, state):
    """Figures of CAPTURE_K cycles a dispatch from `state` (see the
    module docstring)."""
    multi = sim.make_scan_cycle(CAPTURE_K)
    s, _ = multi(state)                 # capture, then the first replay
    torch.cuda.synchronize()
    g = multi.graph

    def replays(n):
        nonlocal s
        t0 = time.perf_counter()
        for _ in range(n):
            s, _ = multi(s)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (n * CAPTURE_K)
    wall_ms = replays(3)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    s, _ = multi(s)
    b.record()
    b.synchronize()
    _, traced = trace(lambda: replays(1), CAPTURE_K)
    return dict({"cycles_a_dispatch": CAPTURE_K,
                 "capture_and_instantiate_s":
                     trace.last_seconds("graph.capture"),
                 "kernel_launches_a_block": {k: v for k, v in
                                             g.launches.items() if v},
                 "wall_ms_per_cycle": wall_ms,
                 "event_ms_per_cycle": a.elapsed_time(b) / CAPTURE_K,
                 "device_busy_share": traced["device_busy_ms_per_cycle"] /
                 wall_ms}, **traced)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--captured", action="store_true",
                    help="also profile the cycles captured 10 a dispatch")
    ap.add_argument("--kernels", action="store_true",
                    help="time the chol and wavefront kernels instead "
                         "(see the module docstring)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.kernels:
        time_kernels(smi)
        return
    sim = SyncSimulator(chip_smoke.forest_mission(),
                        Param(goal_mode=GoalMode.PRIOR_BASED), device="cuda")
    state = sim.initial_state()
    for _ in range(args.warm):
        state, _ = sim.cycle(state)
    torch.cuda.synchronize()

    def run_cycles():
        t0 = time.perf_counter()
        s = state
        for _ in range(args.cycles):
            s, _ = sim.cycle(s)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / args.cycles
    wall_ms = run_cycles()
    traced_wall = []
    device, traced = trace(lambda: traced_wall.append(run_cycles()),
                           args.cycles)
    if traced["device_busy_ms_per_cycle"] <= 0.0:
        raise RuntimeError("the trace holds no device time")
    top = sorted(device, key=device_us, reverse=True)[:10]
    out = dict({
        "card": smi, "cycles": args.cycles, "after": args.warm,
        "wall_ms_per_cycle": wall_ms,
        "traced_wall_ms_per_cycle": traced_wall[0]}, **traced)
    out.update({
        "device_busy_share": traced["device_busy_ms_per_cycle"] / wall_ms,
        "top_kernels_ms_per_cycle": {
            e.key[:80]: device_us(e) / 1e3 / args.cycles for e in top}})
    if args.captured:
        out["captured"] = captured_figures(sim, state)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
