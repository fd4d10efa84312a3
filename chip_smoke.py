#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. a CUDA device is required; prints the card's name and power limit
  2. builds the kernels from lsc_planner_tpu_torch/csrc with nvcc
  3. audit.precision_self_check on the card (the TF32 guard)
  4. each kernel against its plain PyTorch version at n = 39,
     B in {1, 64, 130}, on IPM-like inputs; NaN stays in a non-SPD entry;
     both times (CUDA events, median of 50); plus one f64 cycle of an
     8-agent circle on the card against the CPU
  5. flies the 64-agent circle swap (PRIOR_BASED, float32, all-pairs LSC)
     through SyncSimulator.run() on the card and checks it finished safely
     through the kernels (launch counts = cycles * 40 and cycles * 80)
Then the kernels' JSON line, and last {"ok": true, "device": {...}}.
The script imports nothing of JAX.
"""
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from lsc_planner_tpu_torch import GoalMode, Param, make_circle_mission
from lsc_planner_tpu_torch.convert import state_to_numpy
from lsc_planner_tpu_torch.ops import _build, chol
from lsc_planner_tpu_torch.sim import audit
from lsc_planner_tpu_torch.sim.simulator import SyncSimulator

N_QP = 39                   # QP variables per agent (3 dims x 13)
MAIN_B = 64                 # agents in the flown mission = QP batch
# The JAX package's SyncSimulator.run() of the same 64-agent mission on a
# CPU in float32 (lsc_planner_tpu, dense-row IPM, Param defaults):
# 145 cycles, min safety 1.0071, 0 QPFAILED.
JAX_CPU_F32_CYCLES = 145


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def ipm_like_system(B, n, seed):
    """Jacobi-scaled SPD matrices as _ipm factors them (qp.py:257-258):
    P + A'DA with an interior-point spread of D, unit diagonal."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, 3 * n, n))
    d = np.exp(rng.uniform(-np.log(1e3), np.log(1e3), size=(B, 3 * n)))
    H = np.eye(n) + np.einsum("brv,br,brw->bvw", A, d, A)
    dsc = 1.0 / np.sqrt(np.einsum("bvv->bv", H))
    Hs = H * dsc[:, :, None] * dsc[:, None, :]
    return Hs, rng.normal(size=(B, n)), rng.normal(size=(B, n))


def median_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_kernels(dev):
    """Phase 4: kernel vs plain at the main path's n for several B."""
    out = {}
    for B in (1, MAIN_B, 130):
        Hs, r1, r2 = ipm_like_system(B, N_QP, seed=B)
        H64 = torch.as_tensor(Hs, device=dev)
        R1d = torch.as_tensor(r1, device=dev)
        R2d = torch.as_tensor(r2, device=dev)
        L64, x64 = chol.chol_factor_solve_plain(H64, R1d)
        y64 = chol.chol_resolve_plain(L64, R2d)
        H, R1, R2 = H64.float(), R1d.float(), R2d.float()
        Lp, xp = chol.chol_factor_solve_plain(H, R1)
        yp = chol.chol_resolve_plain(Lp, R2)
        Lk, xk = chol.chol_factor_solve(H, R1)
        yk = chol.chol_resolve(Lk, R2)
        torch.cuda.synchronize()
        errs = {}
        for name, got, plain, ref in (("factor_solve", xk, xp, x64),
                                      ("resolve", yk, yp, y64)):
            e_k = (got.double() - ref).abs().max().item()
            e_p = (plain.double() - ref).abs().max().item()
            if not e_k <= 4 * e_p + 1e-6:
                raise AssertionError(f"{name} B={B}: kernel error {e_k} > "
                                     f"4 x plain f32 error {e_p} + 1e-6")
            errs[name] = (e_k, e_p)
        t = {
            "factor_solve": (median_ms(lambda: chol.chol_factor_solve(H, R1)),
                             median_ms(lambda: chol.chol_factor_solve_plain(
                                 H, R1))),
            "resolve": (median_ms(lambda: chol.chol_resolve(Lk, R2)),
                        median_ms(lambda: chol.chol_resolve_plain(Lk, R2))),
        }
        out[B] = (errs, t)
        phase("4 kernels",
              f"B={B} n={N_QP}: factor_solve err {errs['factor_solve'][0]:.3e}"
              f" (plain f32 {errs['factor_solve'][1]:.3e}) "
              f"{t['factor_solve'][0]:.4f} ms vs plain "
              f"{t['factor_solve'][1]:.4f} ms; resolve err "
              f"{errs['resolve'][0]:.3e} (plain f32 {errs['resolve'][1]:.3e})"
              f" {t['resolve'][0]:.4f} ms vs plain {t['resolve'][1]:.4f} ms")

    # a non-SPD instance turns into NaN in its own entry only
    Hs, r1, r2 = ipm_like_system(MAIN_B, N_QP, seed=7)
    Hs[5, 7, 7] = -1.0
    H = torch.as_tensor(Hs, device=dev, dtype=torch.float32)
    L, x = chol.chol_factor_solve(H, torch.as_tensor(r1, device=dev,
                                                     dtype=torch.float32))
    y = chol.chol_resolve(L, torch.as_tensor(r2, device=dev,
                                             dtype=torch.float32))
    for name, v in (("factor_solve", x), ("resolve", y)):
        bad = (~torch.isfinite(v).all(-1)).nonzero().flatten().tolist()
        if bad != [5]:
            raise AssertionError(f"{name}: non-finite entries {bad}, "
                                 "expected [5]")
    phase("4 kernels", "non-SPD entry 5 of 64 -> NaN in entry 5 only")
    return out


def cycle_parity(dev):
    """Three f64 cycles of an 8-agent circle: the card (f64 kernels) must
    reproduce the CPU run (plain versions) to 1e-6 m."""
    mission = make_circle_mission(8, radius=3.0, world=(-5, -5, 0, 5, 5, 2.5))
    p = Param(goal_mode=GoalMode.PRIOR_BASED)
    runs = []
    for device in (dev, torch.device("cpu")):
        sim = SyncSimulator(mission, p, device=device, dtype=torch.float64)
        state = sim.initial_state()
        for _ in range(3):
            state, _ = sim.cycle(state)
        runs.append(state_to_numpy(state)["traj"])
    err = float(np.abs(runs[0] - runs[1]).max())
    if not err <= 1e-6:
        raise AssertionError(f"8-agent f64 cycles: card vs CPU traj "
                             f"{err} m > 1e-6 m")
    phase("4 kernels", f"8-agent circle, 3 f64 cycles: card vs CPU traj max "
                       f"abs {err:.3e} m (limit 1e-6)")


def main():
    # 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    phase("1 device", f"{torch.cuda.get_device_name(0)}, torch "
                      f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    built = _build.build_seconds
    phase("2 build", f"{_build.library_path().name}: nvcc "
                     f"{'%.2f s' % built if built is not None else 'cached'}"
                     f", load {time.perf_counter() - t0:.2f} s")

    # 3. TF32 guard
    err = audit.precision_self_check(dev)
    phase("3 precision", f"positions_at f32 max error {err:.3e} m "
                         "(limit 1e-3)")

    # 4. kernels vs plain versions
    results = compare_kernels(dev)
    cycle_parity(dev)

    # 5. the main path
    qn = MAIN_B
    radius = max(4.0, 0.45 * qn / math.pi)
    w = radius + 2.0
    mission = make_circle_mission(qn, radius=radius,
                                  world=(-w, -w, 0, w, w, 2.5))
    param = Param(goal_mode=GoalMode.PRIOR_BASED)
    sim = SyncSimulator(mission, param, device=dev, dtype=torch.float32)
    chol.reset_counts()
    summary = sim.run()
    torch.cuda.synchronize()
    launches = {"factor_solve": chol.factor_solve_launches,
                "resolve": chol.resolve_launches}
    cycles = summary["iterations"]
    pos = summary["final_state"].pos
    if not cycles < param.multisim_max_planner_iteration:
        raise AssertionError(f"did not finish within {cycles} cycles")
    if not summary["safety_ratio_agent"] >= 1.0 or summary["is_collided"]:
        raise AssertionError(f"collision: safety "
                             f"{summary['safety_ratio_agent']}")
    if summary["qp_failures"]:
        raise AssertionError(f"{summary['qp_failures']} QPFAILED reports")
    if pos.shape != (qn, 3) or not bool(torch.isfinite(pos).all()):
        raise AssertionError("non-finite final positions")
    want = {"factor_solve": cycles * param.qp_iterations,
            "resolve": cycles * param.qp_iterations *
            (1 + param.qp_correctors)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    ms_cycle = summary["wall_time"] / cycles * 1e3
    phase("5 mission", f"circle{qn} PRIOR_BASED f32: finished in {cycles} "
                       f"cycles (JAX CPU f32: {JAX_CPU_F32_CYCLES}), safety "
                       f"{summary['safety_ratio_agent']:.4f}, 0 QPFAILED, "
                       f"{ms_cycle:.2f} ms/cycle (run wall / cycles; "
                       f"{1e3 * summary['average_planning_time']:.2f} ms "
                       f"mean after the first), launches {launches}")

    errs, times = results[MAIN_B]
    source = "lsc_planner_tpu_torch/csrc/chol.cu"
    kernels = [
        {"name": "chol_factor_solve", "route": "cuda", "source": source,
         "replaces": "lsc_planner_tpu/ops/chol_pallas.py:108",
         "launches": launches["factor_solve"],
         "max_abs_err": errs["factor_solve"][0],
         "ms": times["factor_solve"][0],
         "plain_ms": times["factor_solve"][1]},
        {"name": "chol_resolve", "route": "cuda", "source": source,
         "replaces": "lsc_planner_tpu/ops/chol_pallas.py:123",
         "launches": launches["resolve"],
         "max_abs_err": errs["resolve"][0],
         "ms": times["resolve"][0], "plain_ms": times["resolve"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
