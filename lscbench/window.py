"""Set-up, the measured window, the traced stretch and the result of one
run (``run.py`` parses the arguments and prints)."""
from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

import cell as cell_mod
import check
import tracing


def default_program():
    """The system under test: the port's package, on the card."""
    import lsc_planner_tpu_torch as port
    from lsc_planner_tpu_torch import config, missions
    from lsc_planner_tpu_torch.sim import simulator
    return types.SimpleNamespace(package=port, config=config,
                                 missions=missions,
                                 SyncSimulator=simulator.SyncSimulator,
                                 device="cuda")


def clone_state(state):
    return type(state)(*[None if f is None else f.clone() for f in state])


def read_back(out, k):
    """The window's one device-to-host read a dispatch: each cycle's
    largest goal distance, safety ratio and QPFAILED count, (3, k)."""
    info, gd, _ = out
    return torch.cat([gd.double(), info.safety_step_min.double(),
                      info.qp_failed.sum(-1).double()]).cpu().numpy(
    ).reshape(3, k)


def synchronize(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(c, seed, seconds, trace, setup_seconds, program=None,
             until_kept=False):
    """One run of cell c (see run.py).  Returns the result's fields and
    "checks" {name: (value, limit, kind)}.  With until_kept the window
    also runs on until every dispatch the check keeps has run (the
    control and the CPU tests, whose dispatches are slow)."""
    prog = program or default_program()
    dev = torch.device(prog.device)
    spans = tracing.Spans()
    k = c.k
    with spans("mission"):
        arrays = c.mission_arrays(seed)
        mission = cell_mod.build_mission(prog.missions, arrays,
                                         c.config["agent"])
        param = cell_mod.build_param(prog.config, c.config)
    with spans("simulator"):
        sim = prog.SyncSimulator(mission, param, device=dev,
                                 dtype=getattr(torch, c.config["dtype"]))
        init = sim.initial_state()
    with spans("capture"):
        multi = sim.make_scan_cycle(k)
        read_back(multi(init)[1], k)
        synchronize(dev)
    with spans("warm_up"):
        # a fixed number of replays, so that the card runs the window's
        # work at its steady pace from the first dispatch
        s = init
        for _ in range(int(c.workload.get("warm_dispatches", 0))):
            s, out = multi(s)
            read_back(out, k)
        del s
        synchronize(dev)
    setup_s = setup_seconds()

    # the window
    threshold = float(param.goal_threshold)
    cap = int(c.traffic.get("restart_after_cycles", 1000))
    keep_at = check.kept_dispatches(c.workload["check"], seed)
    keeps = []
    dispatch_s, safety_min, failed = [], float("inf"), 0
    cycles = restarts = mission_cycles = 0
    state, d = init, 0
    w0 = time.perf_counter()
    while True:
        pre = clone_state(state) if d in keep_at else None
        t0 = time.perf_counter()
        with spans("replay"):
            nxt, out = multi(state)
        with spans("host_read"):
            gd, safety, n_failed = read_back(out, k)
        t1 = time.perf_counter()
        dispatch_s.append(t1 - t0)
        if pre is not None:
            keeps.append(check.Kept(d, pre, clone_state(nxt),
                                    clone_state(out[0])))
        cycles += k
        mission_cycles += k
        safety_min = min(safety_min, float(safety.min()))
        failed += int(n_failed.sum())
        if (gd < threshold).any() or mission_cycles >= cap:
            with spans("restart"):
                state, mission_cycles = init, 0
                restarts += 1
        else:
            state = nxt
        d += 1
        if t1 - w0 >= seconds and not (until_kept and d <= max(keep_at)):
            break
    window_s = t1 - w0
    synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    rec = types.SimpleNamespace(
        cell=c.name, k=k, agents=sim.N, setup_s=setup_s, window_s=window_s,
        cycles=cycles, dispatch_s=dispatch_s, restarts=restarts,
        spans=spans.items, trace=None, probes={})
    breakdown = None
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        last = clone_state(nxt)
        rec.trace = traced_stretch(
            multi, last, k, int(c.workload["trace"]["dispatches"]), spans,
            dev)
        ctx = types.SimpleNamespace(sim=sim, state=last, program=prog,
                                    device=dev, k=k, cache={})
        for m in c.per_layer:
            mod = c.reader(m["name"])
            if hasattr(mod, "probe"):
                rec.probes[m["name"]] = mod.probe(ctx)
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        breakdown = {
            "device_ops": sorted(
                ([tracing.kernel_name(key) if tracing.own_kernel(key)
                  else key[:100], v[0]] for key, v in
                 {**rec.trace["kernels"], **rec.trace["copies"]}.items()),
                key=lambda e: -e[1])[:10],
            "idle_gaps": [[n, s] for n, s in rec.trace["gaps"][:10]]}
        del ctx, last
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = c.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state freed before the reference runs
    del multi, sim, init, state, nxt, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, figures = check.judge(c, arrays, keeps, safety_min, dev)
    t_check = time.perf_counter() - t_check
    correct = all(check.holds(v, lim, kind)
                  for v, lim, kind in checks.values())
    agents = rec.agents
    return {"correct": correct, "attempted": agents * cycles,
            "failed": failed, "metrics": metrics, "device": device,
            "breakdown": breakdown, "checks": checks,
            "info": {"setup_s": setup_s, "window_s": window_s,
                     "dispatches": len(dispatch_s), "restarts": restarts,
                     "kept": [kp.d for kp in keeps],
                     "check_s": t_check, "figures": figures,
                     "dispatch_ms": _quantiles(dispatch_s)}}


def _quantiles(xs):
    """ms at the 0, 50, 90, 95, 99 and 100th percentiles of seconds xs."""
    if not xs:
        return None
    return [round(1e3 * float(np.percentile(xs, q)), 3)
            for q in (0, 50, 90, 95, 99, 100)]


def traced_stretch(multi, state, k, n, spans, dev):
    """n dispatches from `state` under the profiler.  Returns
    tracing.profile's figures with "cycles"."""
    synchronize(dev)

    def stretch():
        with spans("traced"):
            s = state
            for _ in range(n):
                with spans("replay"):
                    s, out = multi(s)
                with spans("host_read"):
                    read_back(out, k)
    spans.profiling = True
    try:
        fig = tracing.profile(stretch)
    finally:
        spans.profiling = False
    fig["cycles"] = n * k
    return fig
