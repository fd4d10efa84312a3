#!/usr/bin/env python3
"""The benchmark of lsc_planner_tpu_torch, the PyTorch and CUDA port: one
run of one cell on one H100.

    python3 lscbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run: checks that the configuration names a plain reference the
benchmark holds, and for a CUDA card (none, or fewer than the cell asks
for: exit 2, no result); makes the cell's mission from --seed
(``traffic/``); builds ``SyncSimulator(mission, Param(...),
device="cuda")``; warms up the cell's one shape, a CUDA graph of k
planning cycles (``cycle_graph(k, state)``: the kernels' nvcc build on a
checkout's first run, a warm-up cycle, the capture) and one replay: that
is set-up.  The window then replays the graph back to back for --seconds,
as ``SyncSimulator.run(steps_per_dispatch=k)`` does, with one
device-to-host read a dispatch (goal distances, safety, QPFAILED), timed
on the host clock from the replay call to the end of that read.  A mission
whose agents are all home, or that has run ``restart_after_cycles``,
restarts from its initial state (copied into the graph's inputs, no new
capture).  After the window: with --trace 1 a stretch of dispatches under
torch.profiler and the per-layer metrics' probes; the device's peak
memory; the program freed; the configuration's plain reference judges
the dispatches the check kept (``check.py``).  Prints the numbers
compared, each beside its limit, as the last lines of standard error, and
one JSON line last on standard output.  Imports nothing of JAX or of the
JAX package; exits 3, with no result, if either is loaded when the run
ends.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()


def _since_process_start() -> float:
    """Seconds from this process's creation to now (Linux /proc)."""
    import os
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_BEFORE_T0 = _since_process_start() - (time.perf_counter() - _T0)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every cache at a fixed path inside the checkout (the port's nvcc builds
# go to lsc_planner_tpu_torch/_build/, keyed by source hash, by itself)
_CACHE = BENCH_DIR / "_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(_CACHE / _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "lsc_planner_tpu")


def setup_seconds() -> float:
    return _BEFORE_T0 + time.perf_counter() - _T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole (the port's lsc_planner_tpu_torch
    begins with the JAX package's name and is not one of them)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, program=None, root=None, bench_dir=None) -> int:
    """One run; returns the exit code.  `program` replaces the port's
    package on the card (the tests hand in one on the CPU, and broken
    ones); `root` and `bench_dir` the checkout's root and the benchmark's
    folder (the tests' copies)."""
    args = parse(argv)
    import torch
    import cell as cell_mod
    import window
    c = cell_mod.find(args.workload, root or ROOT, bench_dir or BENCH_DIR)
    try:
        c.reference()
    except LookupError as e:
        print(f"lscbench: {e}", file=sys.stderr)
        return 2
    if program is None:
        if not torch.cuda.is_available():
            print("lscbench: torch.cuda.is_available() is False: the "
                  "benchmark measures the card and never falls back to the "
                  "CPU", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < c.chips:
            print(f"lscbench: cell {c.name} needs {c.chips} CUDA devices, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    result = window.run_cell(c, args.seed, args.seconds, bool(args.trace),
                             setup_seconds, program=program,
                             until_kept=program is not None)
    found = forbidden_modules()
    if found:
        print(f"lscbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"lscbench: {json.dumps(result['info'])}", file=sys.stderr)
    for name, (value, limit, kind) in result["checks"].items():
        print(f"check {name} = {value!r} (limit: {kind} {limit!r})",
              file=sys.stderr)
    print(f"check correct = {result['correct']}", file=sys.stderr)
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if result.get("breakdown") is not None:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim, "holds": kind}
                      for name, (v, lim, kind) in result["checks"].items()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
