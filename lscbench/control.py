#!/usr/bin/env python3
"""The check's control: the plain reference put in the program's place
and run in the nearest precision below the configuration's, float32 with
TF32 matmuls (the configurations state float32 with TF32 off, as the
port's ``device.exact_float32`` sets it), on the card at the cell's own
size.  Its dispatches are judged by ``check.py`` exactly as the
program's are, and ``correct`` has to come out false.

    python3 lscbench/control.py --workload <cell> --seeds 11,12,13 \
        [--precision tf32|f32]

Prints one JSON line a seed: the numbers compared and ``correct``.
``--precision f32`` runs the same reference with TF32 off (a sound run of
the reference in the program's precision).  Not run by ``run.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))


def reference_program(device="cuda"):
    """The reference as the system under test: its SyncSimulator with the
    k-cycle dispatch that ``make_scan_cycle`` gives on the CPU (k eager
    cycles, the outputs stacked as a replay's)."""
    from reference import lsc
    from reference.lsc import config, missions
    from reference.lsc.sim import simulator

    class Sim(simulator.SyncSimulator):
        def make_scan_cycle(self, k):
            return lambda state: simulator._stack_cycles(self.cycle, state,
                                                         k)
    return types.SimpleNamespace(package=lsc, config=config,
                                 missions=missions, SyncSimulator=Sim,
                                 device=device)


def run_control(cell_name, seed, precision="tf32", device="cuda",
                root=None, bench_dir=None):
    """One control run of cell_name at seed; returns (correct, checks,
    the figures printed beside them)."""
    import torch
    import cell as cell_mod
    import window
    c = cell_mod.find(cell_name, root or cell_mod.ROOT,
                      bench_dir or cell_mod.BENCH_DIR)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        t0 = time.perf_counter()
        res = window.run_cell(c, seed, 0.0, False, lambda: time.perf_counter()
                              - t0, program=reference_program(device),
                              until_kept=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return res["correct"], res["checks"], res["info"]["figures"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", choices=("tf32", "f32"), default="tf32")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        correct, checks, figures = run_control(args.workload, seed,
                                               args.precision)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision, "correct": correct,
                          "seconds": time.perf_counter() - t0,
                          "checks": {n: v[0] for n, v in checks.items()},
                          "figures": figures}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
