#!/usr/bin/env python3
"""Profile the port's forest20 cycle on one CUDA GPU.

    python3 scripts/profile_forest20_torch.py [--warm 20] [--cycles 3]

Builds chip_smoke.py's forest20 (20 agents, 60 tree columns, seed 0) on
the card, runs --warm cycles, then traces --cycles cycles with
torch.profiler (CPU + CUDA).  Prints, as one JSON line: the card's name
and power limit, wall ms a cycle of the same cycles run twice from the same
state (host clock, synchronised): once untraced and once under the
profiler, which slows the host; kernel launches and memory copies/sets a
cycle; device-busy ms a cycle (the sum of the device time of both) and its
share of the untraced wall time; and the ten kernels with the most device
time.  Fails when the trace
holds no device time.  Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from lsc_planner_tpu_torch import GoalMode, Param  # noqa: E402
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator  # noqa: E402


def device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--cycles", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced_wall_ms = run_cycles()
    device = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    copies = [e for e in device if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in device if e not in copies]
    busy_us = sum(device_us(e) for e in device)
    launches = sum(e.count for e in kernels)
    if busy_us <= 0.0:
        raise RuntimeError("the trace holds no device time")
    top = sorted(device, key=device_us, reverse=True)[:10]
    print(json.dumps({
        "card": smi, "cycles": args.cycles, "after": args.warm,
        "wall_ms_per_cycle": wall_ms,
        "traced_wall_ms_per_cycle": traced_wall_ms,
        "kernel_launches_per_cycle": launches / args.cycles,
        "copies_and_sets_per_cycle": sum(e.count for e in copies) /
        args.cycles,
        "device_busy_ms_per_cycle": busy_us / 1e3 / args.cycles,
        "device_busy_share": busy_us / 1e3 / args.cycles / wall_ms,
        "top_kernels_ms_per_cycle": {
            e.key[:80]: device_us(e) / 1e3 / args.cycles for e in top},
    }), flush=True)


if __name__ == "__main__":
    main()
